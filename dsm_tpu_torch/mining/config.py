"""Typed mining configuration covering every reference knob (the port's
copy of dsm_tpu/mining/config.py; `convert.config_from_jax` carries one
over).

Client knobs (metaenumerate.cpp:141-190): fmin, maxdepth, enforced prefix.
Server knobs (metaserver.cpp:517-580): pmin, pmax, emin, emax, mindepth,
topfreq, toptimes, verbose/debug/outputall.
"""

from __future__ import annotations

from dataclasses import dataclass

UNLIMITED = 0xFFFFFFFF  # maxdepth default ~0u (metaenumerate.cpp:142)


@dataclass(frozen=True)
class MiningConfig:
    # enumeration (client side)
    fmin: int = 10            # metaenumerate.cpp:141 binary default
    maxdepth: int = UNLIMITED
    # merge / output gates (server side)
    pmin: int = 2             # metaserver.cpp:127
    pmax: int = 0             # 0 = no limit (metaserver.cpp:128)
    emin: float = 0.0
    emax: float = -1.0        # mandatory in the reference (< 0 = unset)
    mindepth: int = 0
    # reporting
    topfreq: int = 0
    toptimes: int = 0
    verbose: bool = False
    debug: bool = False
    outputall: bool = False

    def validate(self) -> None:
        if self.emax < 0:
            raise ValueError("expecting parameter --emax (metaserver.cpp:582-586)")
        if self.emin > self.emax:
            raise ValueError("--emin must be <= --emax (metaserver.cpp:589-593)")
        if self.fmin < 1 or self.pmin < 1:
            raise ValueError("fmin and pmin must be >= 1")
