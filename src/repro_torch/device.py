"""Device choice for every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: there is
no silent fallback.  ``resolve_device`` also pins float32 matrix products
to full float32 (no TF32), so float32 runs compare against the reference
at float32 precision.  ``meta`` is accepted when asked for by name: shape
recording (``sparsity.model_matmul_shapes``) builds a model there, which
allocates nothing and touches no card.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "synchronize"]

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means "cuda".  A CUDA device without CUDA raises, naming the
    way to run on the CPU; nothing falls back by itself."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' (--device cpu on the "
            "command line) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
