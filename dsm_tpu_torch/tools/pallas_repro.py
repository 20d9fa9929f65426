"""The three cases of tools/pallas_repro.py on a torch device.

    python -m dsm_tpu_torch.tools.pallas_repro [--device cuda|cpu]

Each case runs its kernel (ops/repro.py, csrc/repro.cu) on x = arange(1024)
int32 and prints PASS, MISMATCH (with the heads of both arrays) or the
failure, as the JAX tool does for its Pallas kernels:
  smem_carry    : x + the index of each 256-element block;
  async_copy    : 2x through shared memory and one bulk async copy;
  dynamic_store : x, stored at a data-dependent offset.
The exit status is 1 when a case does not pass.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.repro import BLOCK, async_copy, dynamic_store, smem_carry

N = 1024   # tools/pallas_repro.py N


def expected(device) -> dict[str, torch.Tensor]:
    """The arrays the JAX tool checks each case against."""
    x = np.arange(N, dtype=np.int32)
    want = {"smem_carry": x + np.repeat(np.arange(N // BLOCK), BLOCK),
            "async_copy": x * 2, "dynamic_store": x}
    return {k: torch.as_tensor(v.astype(np.int32), device=device)
            for k, v in want.items()}


CASES = {"smem_carry": smem_carry, "async_copy": async_copy,
         "dynamic_store": dynamic_store}


def run_cases(device) -> dict[str, str]:
    """-> {case: "PASS" | "MISMATCH (...)" | "FAILURE: ..."}."""
    x = torch.arange(N, dtype=torch.int32, device=device)
    want = expected(device)
    report = {}
    for name, fn in CASES.items():
        try:
            got = fn(x)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except (RuntimeError, ValueError) as e:
            report[name] = f"FAILURE: {str(e)[:160]}"
            continue
        if torch.equal(got, want[name]):
            report[name] = "PASS"
        else:
            report[name] = (f"MISMATCH (got head {got[:8].tolist()}, want "
                            f"head {want[name][:8].tolist()})")
    return report


def main(argv=None) -> int:
    from ..utils.device import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m dsm_tpu_torch.tools.pallas_repro",
        description="The cases of tools/pallas_repro.py on a torch device.")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; pass --device cpu to "
                         "run the plain versions)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"pallas_repro: {e}")
    report = run_cases(device)
    for name, status in report.items():
        print(f"{name}: {status}")
    return 0 if all(s == "PASS" for s in report.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
