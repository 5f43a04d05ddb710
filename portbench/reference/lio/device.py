"""Where the port's entry points and constructors put their tensors."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; a CUDA request without a card
    is an error, never a silent move to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "malio_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU"
        )
    return dev


_CARRY = [torch.float64]


def carry_dtype() -> torch.dtype:
    """The dtype P and Pi are carried in from round to round: float64, as
    the configurations state."""
    return _CARRY[0]


def set_carry_dtype(dtype=torch.float64) -> None:
    """The f32_carry control lowers it to float32 (reference/replay.py)."""
    _CARRY[0] = dtype
