"""repro_torch: the RBGP block-sparse serving stack on PyTorch and CUDA.

The port of ``repro`` (JAX, TPU) to an NVIDIA H100.  Its modules mirror the
JAX package's paths and names; the JAX package stays the reference.  The
port imports torch, numpy and the standard library only.
"""

from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
