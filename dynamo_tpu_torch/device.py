"""Device selection for the port's entry points.

Every entry point takes `device=`, defaulting to "cuda". Asking for the card
where there is none raises: nothing here ever falls back to the CPU. Only an
explicit `device="cpu"` (as the tests pass) runs on the host.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run on the host")
        # Full float32 everywhere: a reference that silently drops to TF32
        # keeps about three decimal digits.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev
