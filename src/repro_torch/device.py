"""Device resolution for the port's entry points.

Entry points default to `device="cuda"`. There is no silent CPU fallback:
asking for CUDA where `torch.cuda.is_available()` is false raises, and
only a caller that passes `device="cpu"` (the tests) runs on the CPU, where
every kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions on the "
            "CPU"
        )
    return dev
