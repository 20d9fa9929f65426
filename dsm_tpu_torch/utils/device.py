"""Device selection for the port (counterpart of dsm_tpu/utils/jaxsetup.py).

The port keeps no device in module state: every entry point takes a
`device` argument and passes it down.  Asking for CUDA where there is
none is an error, never a quiet move to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """torch.device for `name` ("cuda", "cuda:1", "cpu" or a device);
    raises RuntimeError for a CUDA device this process cannot see."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but CUDA is not available "
                "(pass device='cpu' / --device cpu to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {name!r} does not exist "
                               f"({torch.cuda.device_count()} visible)")
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {name!r} (cuda or cpu)")
    return dev
