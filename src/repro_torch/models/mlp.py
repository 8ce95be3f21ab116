"""Gated MLP (SwiGLU / GeGLU) with SparseLinear projections.

The port of ``repro/models/mlp.py``: the gate projection asks for its
activation as the kernel's epilogue (``fuse=act``), so on the card the
activation runs on the f32 accumulator of ``rbgp4mm_rhs`` before its single
store.  Activations outside ``EPILOGUE_ACTS`` run as a separate op.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import EPILOGUE_ACTS
from repro_torch.sparsity import SparseLinear

__all__ = ["GatedMLP", "ACTS"]

ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    "relu2": lambda x: torch.relu(x) ** 2,
}


class GatedMLP(nn.Module):
    """y = down( act(gate(x)) * up(x) )."""

    def __init__(self, d_model: int, d_ff: int, sparsity, act: str = "silu",
                 *, name: str = "mlp", **kw):
        super().__init__()
        self.act = ACTS[act]
        self.act_name = act
        self.fuse = act if act in EPILOGUE_ACTS else None
        self.gate = SparseLinear(d_model, d_ff, sparsity, name=f"{name}.gate",
                                 **kw)
        self.up = SparseLinear(d_model, d_ff, sparsity, name=f"{name}.up",
                               **kw)
        self.down = SparseLinear(d_ff, d_model, sparsity, name=f"{name}.down",
                                 **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.gate(x, fuse=self.fuse)
        if self.fuse is None:
            g = self.act(g)
        return self.down(g * self.up(x))
