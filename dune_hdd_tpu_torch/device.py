"""The device an entry point runs on: the card, unless the caller asks for
the CPU.  Without a card a CUDA request raises; nothing falls back."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "highest_precision"]


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


def highest_precision() -> None:
    """Full float32 products everywhere: TF32 assembles an asymmetric
    operator (~1e-3 relative), which breaks CG."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
