"""RBGP4 token-major sparse product ``rbgp4mm_rhs`` and its plain version.

The port of the forward of ``repro/kernels/rbgp4mm.py:rbgp4mm_rhs``:

    Y = act(X @ W_s^T + bias) + residual;  X (N, K) -> Y (N, M)

with W_s in compact RBGP4 storage ``w_data`` (M, d_o*d_i*C).  On a CUDA
tensor the wrapper launches the hand-written kernel in
``csrc/rbgp4mm_rhs.cu`` (see its source note for the design and what bounds
it); on a CPU tensor it runs ``rbgp4mm_rhs_reference``, the plain version.
There is no other path: a failed build or launch raises.

``rbgp4mm_rhs.launches`` counts kernel launches (plain runs never count).
The int8 ``scales=`` path and ``save_preact`` come with later slices.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .ref import gather_mm_rhs

__all__ = ["KernelDims", "KernelTables", "EPILOGUE_ACTS", "rbgp4mm_rhs",
           "rbgp4mm_rhs_reference"]

# Activations fusable into the epilogue; names match ``models.mlp.ACTS``.
EPILOGUE_ACTS = {
    "relu": torch.relu,
    "gelu": lambda z: F.gelu(z, approximate="tanh"),
    "silu": F.silu,
}
_ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class KernelDims:
    """Static kernel dimensions derived from an RBGP4Layout."""

    m: int               # rows of W_s / columns of Y
    k: int               # cols of W_s / columns of X
    tile_m: int          # TM = U_i * G
    tile_k: int          # TK = V_i * C
    group_rows: int      # G
    chunk_cols: int      # C
    d_o: int             # non-zero tiles per tile-row
    d_i: int             # non-zero inner blocks per group-row
    u_i: int             # |G_i.U|
    v_i: int             # |G_i.V|

    @property
    def n_col_tiles(self) -> int:
        return self.k // self.tile_k

    @property
    def data_cols(self) -> int:
        return self.d_o * self.d_i * self.chunk_cols

    @classmethod
    def from_layout(cls, layout) -> "KernelDims":
        sp = layout.spec
        return cls(
            m=sp.m, k=sp.k, tile_m=sp.tile_m, tile_k=sp.tile_k,
            group_rows=sp.group_rows, chunk_cols=sp.chunk_cols,
            d_o=sp.d_o, d_i=sp.d_i, u_i=sp.g_i[0], v_i=sp.g_i[1],
        )


@dataclasses.dataclass(frozen=True, eq=False)
class KernelTables:
    """A layout's kernel dimensions and index tables on one device.

    Built once per layer (``SparseLinear`` holds one) and passed to every
    call, so a call does no host-side layout work.  ``col0`` (M/G, d_o*d_i)
    int32 is what the kernel reads: row group ``rg = o*u_i + u`` and slot
    ``s = kk*d_i + ki`` read input columns ``col0[rg, s] + c`` for
    ``c < C``, with ``col0[rg, s] = adj_o[o, kk]*TK + adj_i[u, ki]*C``.
    ``adj_o`` (n_o_l, d_o) and ``adj_i`` (u_i, d_i) int64 are the plain
    version's gather indices.
    """

    dims: KernelDims
    col0: torch.Tensor
    adj_o: torch.Tensor
    adj_i: torch.Tensor

    @classmethod
    def build(cls, layout, device) -> "KernelTables":
        dims = KernelDims.from_layout(layout)
        adj_o = np.asarray(layout.adj_o, np.int64)
        adj_i = np.asarray(layout.adj_i, np.int64)
        col0 = (adj_o[:, None, :, None] * dims.tile_k
                + adj_i[None, :, None, :] * dims.chunk_cols)
        col0 = col0.reshape(dims.m // dims.group_rows, dims.d_o * dims.d_i)

        def on_device(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

        return cls(dims, on_device(col0, torch.int32),
                   on_device(adj_o, torch.int64),
                   on_device(adj_i, torch.int64))


def _check_args(dims, x, w_data, act):
    if tuple(w_data.shape) != (dims.m, dims.data_cols):
        raise ValueError(
            f"w_data {tuple(w_data.shape)} != {(dims.m, dims.data_cols)}")
    if x.ndim != 2 or x.shape[1] != dims.k:
        raise ValueError(f"x {tuple(x.shape)} is not (N, K={dims.k})")
    if act is not None and act not in EPILOGUE_ACTS:
        raise ValueError(f"act {act!r} not in {sorted(EPILOGUE_ACTS)}")


def rbgp4mm_rhs_reference(tables: KernelTables, x: torch.Tensor,
                          w_data: torch.Tensor, *,
                          bias: Optional[torch.Tensor] = None,
                          act: Optional[str] = None,
                          residual: Optional[torch.Tensor] = None,
                          out_dtype=None) -> torch.Tensor:
    """Plain version: gather + einsum in f32, then the epilogue in f32."""
    dims = tables.dims
    _check_args(dims, x, w_data, act)
    z = gather_mm_rhs(tables.adj_o, tables.adj_i, dims.n_col_tiles,
                      dims.group_rows, dims.chunk_cols, w_data.float(),
                      x.float())
    if bias is not None:
        z = z + bias.float()
    y = EPILOGUE_ACTS[act](z) if act is not None else z
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype or x.dtype)


_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The kernel's library (built at first use) with its C signatures
    declared: without ``argtypes`` ctypes would cut pointers to 32 bits."""
    global _LIB
    if _LIB is None:
        lib = build.load("rbgp4mm_rhs")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rbgp4mm_rhs_launch.argtypes = [i, p, p, p, p, p, p,
                                           i, i, i, i, i, i, i, p]
        lib.rbgp4mm_rhs_launch.restype = i
        lib.rbgp4mm_rhs_error_string.argtypes = [i]
        lib.rbgp4mm_rhs_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def rbgp4mm_rhs(tables: KernelTables, x: torch.Tensor,
                w_data: torch.Tensor, *,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None,
                residual: Optional[torch.Tensor] = None,
                out_dtype=None) -> torch.Tensor:
    """Y = act(X @ W_s^T + bias) + residual; X (N, K) token-major -> Y (N, M).

    ``tables`` are the layout's kernel tables on the device of ``x``.
    CPU tensors run the plain version; CUDA tensors launch the kernel, which
    takes float32 or bfloat16 X with W, bias and residual of the same dtype,
    all contiguous, and writes Y in that dtype.
    """
    dims = tables.dims
    _check_args(dims, x, w_data, act)
    if x.device.type == "cpu":
        return rbgp4mm_rhs_reference(tables, x, w_data, bias=bias, act=act,
                                     residual=residual, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"rbgp4mm_rhs runs on cuda or cpu, got {x.device}")
    dt = x.dtype
    if dt not in _DTYPE_CODES:
        raise TypeError(f"rbgp4mm_rhs kernel takes float32 or bfloat16, "
                        f"got {dt}")
    if out_dtype is not None and out_dtype != dt:
        raise TypeError(f"rbgp4mm_rhs kernel writes Y in the dtype of X "
                        f"({dt}), got out_dtype={out_dtype}")
    if tables.col0.device != x.device:
        raise ValueError(f"kernel tables are on {tables.col0.device}, x on "
                         f"{x.device}")
    n, m = x.shape[0], dims.m
    operands = {"x": x, "w_data": w_data}
    if bias is not None:
        operands["bias"] = bias
        if tuple(bias.shape) != (m,):
            raise ValueError(f"bias {tuple(bias.shape)} != ({m},)")
    if residual is not None:
        operands["residual"] = residual
        if tuple(residual.shape) != (n, m):
            raise ValueError(f"residual {tuple(residual.shape)} != {(n, m)}")
    for name, t in operands.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, x is {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((n, m), dtype=dt, device=x.device)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rbgp4mm_rhs_launch(
            _DTYPE_CODES[dt], x.data_ptr(), w_data.data_ptr(),
            tables.col0.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            residual.data_ptr() if residual is not None else None,
            out.data_ptr(), n, dims.k, m, dims.d_o * dims.d_i,
            dims.group_rows, dims.chunk_cols, _ACT_CODES[act], stream,
        )
    if err != 0:
        msg = lib.rbgp4mm_rhs_error_string(err).decode()
        raise RuntimeError(f"rbgp4mm_rhs launch failed: CUDA error {err} "
                           f"({msg})")
    rbgp4mm_rhs.launches += 1
    return out


rbgp4mm_rhs.launches = 0
