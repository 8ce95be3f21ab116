"""Weight containers and the sparse-backend registry: the one dispatch
point of every projection.

The port of ``repro/sparsity/api.py``.  Two orthogonal concepts:

**Weight containers** say how the values are stored:

  ``DenseWeight``    plain (M, K) values.
  ``MaskedWeight``   dense (M, K) trainable values under a fixed {0, 1}
                     mask.  RBGP4 masks are carried as the base graphs'
                     biadjacency factors ``ba_o``/``ba_i`` and expanded at
                     each call (``expand_rbgp4_mask``); the unstructured
                     and block patterns carry the full ``mask``.  ``w`` may
                     carry a leading expert dim (E, M, K); the mask
                     broadcasts.
  ``CompactWeight``  compact RBGP4 (M, nnz_row) values + their layout's
                     kernel tables (``col0``, which a rank's share of the
                     layout cuts, and the adjacency of a whole layout).
  ``ChainWeight``    deep-chain (M, nnz_row) values + their layout's table
                     (``sparsity/chain.py``).
  ``QuantizedWeight`` the weight-only int8 storage of a compact or chain
                     container (``sparsity/quant.py`` makes it): int8 leaf
                     blocks ``q_data`` and one float32 scale per (G, C)
                     leaf block.

**Backends** are registered executors that say how the product runs:

  ``ref``          the dense materialization ``x @ dense_weight(w).T``
                   (Dense, Masked and Compact containers).
  ``xla_masked``   ``x @ (w * mask).T``: the paper-faithful training path
                   of predefined sparsity, one dense product.
  ``xla_compact``  gather + einsum from compact storage in plain torch (no
                   dense W), read through ``col0``
                   (``kernels.ref.gather_mm_rhs_col0``), so a rank's share
                   of a layout runs it too; ``matmul`` is the reference's
                   ``compact_gather_mm``.
  ``pallas``       the hand-written CUDA kernels ``rbgp4mm_rhs``,
                   ``rbgp4mm_rhs_stacked`` and ``rbgp4mm`` (through
                   ``RBGP4Linear``, ``RBGP4LinearStacked`` and
                   ``RBGP4MatMul`` where a gradient is asked for), with
                   bias, activation and residual fused into the kernel's
                   epilogue; on a CPU tensor their plain versions, as the
                   reference runs Pallas in interpret mode off the TPU.
  ``chain``        the ``chainmm_rhs`` kernel (``ChainLinear`` where a
                   gradient is asked for); ``matmul`` densifies.
  ``quant``        int8 storage: on the card the ``scales=`` paths of
                   ``rbgp4mm_rhs``, ``rbgp4mm_rhs_stacked`` and
                   ``chainmm_rhs``, with no epilogue in the kernel; on the
                   CPU, and for ``matmul`` everywhere, the container is
                   dequantized and handed to the backend ``auto`` picks
                   for it, so the result is bit for bit that of the
                   dequantized weights.  PTQ storage is inference-only: an
                   input that needs a gradient raises.

Each backend declares :class:`BackendCapabilities` (needs_layout,
compact_storage, chain_storage, grad_support, platforms, epilogue, batched,
quant): :func:`available_backends` filters by them, :func:`storage_kind`
reads them to decide what a layer stores, and :func:`register_backend`
adds an executor without touching any model file.  ``platforms`` holds
``torch.device`` types: the reference's tuple, with the port's ``cuda``
in place of the TPU.

The functional entry points :func:`sparse_linear` (token-major ``y = x @
W_s^T``), :func:`sparse_linear_batched` (stacked experts, x (E, ..., K) ->
(E, ..., M)) and :func:`sparse_matmul` (the paper's feature-major ``O =
W_s @ I``, x (K, N) -> (M, N)) resolve ``(weight type, backend name)``
through :func:`resolve_backend`.  Bias, activation and residual run inside
a backend that declares ``epilogue``, and as torch ops after it
otherwise.  ``backend="auto"`` picks ``quant`` for int8 storage, ``chain``
for chains, ``xla_masked`` for masked and ``ref`` for dense storage, and
``pallas`` for compact storage on every device: the reference picks
``xla_compact`` off the TPU, but the port's kernel wrapper is the compact
path on both devices (its plain version on the CPU), so ``auto`` never
runs a plain version on the card.  A named backend that does not accept a
``QuantizedWeight`` reroutes to ``quant``: a plan written before
quantization keeps naming the full-precision executor.

``dense_weight`` materializes the dense (M, K) matrix of any container.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Optional, Protocol, Union,
                    runtime_checkable)

import torch

from repro_torch.kernels import (EPILOGUE_ACTS, ChainTables, KernelTables,
                                 TransposeTables, chainmm_rhs, rbgp4mm_rhs,
                                 rbgp4mm_rhs_stacked)
from repro_torch.kernels.ops import (chain_linear, compact_linear,
                                     compact_linear_stacked, compact_matmul,
                                     needs_grad)
from repro_torch.kernels.ref import gather_mm, gather_mm_rhs_col0

from .chain import ChainWeight

__all__ = ["DenseWeight", "MaskedWeight", "CompactWeight", "ChainWeight",
           "QuantizedWeight", "SparseWeight", "BackendCapabilities",
           "SparseBackend", "register_backend", "get_backend",
           "available_backends", "resolve_backend", "storage_kind",
           "sparse_linear", "sparse_linear_batched", "sparse_matmul",
           "dense_weight", "expand_rbgp4_mask"]


def expand_rbgp4_mask(ba_o: torch.Tensor, ba_i: torch.Tensor, G: int,
                      C: int) -> torch.Tensor:
    """mask = kron(ba_o, kron(ba_i, ones(G, C))) without the krons:
    ba_o (n_o_l, n_o_r), ba_i (u_i, v_i) -> (n_o_l*u_i*G, n_o_r*v_i*C)."""
    inner = ba_o[:, None, :, None] * ba_i[None, :, None, :]  # (ol,ui,or,vi)
    ol, ui, onr, vi = inner.shape
    mask = inner[:, :, None, :, :, None].expand(ol, ui, G, onr, vi, C)
    return mask.reshape(ol * ui * G, onr * vi * C)


@dataclasses.dataclass
class DenseWeight:
    """Plain dense values: ``w`` (M, K), optional bias ``b`` (M,); stacked
    over experts, (E, M, K) and (E, M)."""

    w: torch.Tensor
    b: Optional[torch.Tensor] = None


@dataclasses.dataclass
class MaskedWeight:
    """Dense trainable values ``w`` (..., M, K) under a fixed {0, 1} mask.

    Exactly one mask source is set: the (``ba_o``, ``ba_i``) biadjacency
    factors with the (``group_rows``, ``chunk_cols``) repetition sizes
    (rbgp4: the mask is expanded at each call, never stored), or the full
    ``mask`` (unstructured and block patterns).  The mask sources are
    integer tensors, never trained."""

    w: torch.Tensor
    ba_o: Optional[torch.Tensor] = None
    ba_i: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None
    group_rows: Optional[int] = None
    chunk_cols: Optional[int] = None
    window: Optional[tuple[int, int, int, int]] = None

    def mask_array(self, dtype=None) -> torch.Tensor:
        """The (M, K) {0, 1} mask (expanded from the factors if
        succinct); with ``window`` (row_lo, row_hi, col_lo, col_hi), the
        part of it a rank's share of ``w`` stands under (tensor
        parallelism keeps the whole mask and cuts ``w``)."""
        if self.mask is not None:
            m = self.mask
        else:
            m = expand_rbgp4_mask(self.ba_o, self.ba_i, self.group_rows,
                                  self.chunk_cols)
        if self.window is not None:
            r0, r1, c0, c1 = self.window
            m = m[r0:r1, c0:c1]
        return m.to(dtype) if dtype is not None else m

    def materialize(self, dtype=None) -> torch.Tensor:
        """w * mask: the effective dense weight."""
        dtype = dtype or self.w.dtype
        return self.w.to(dtype) * self.mask_array(dtype)


@dataclasses.dataclass
class CompactWeight:
    """Compact RBGP4 storage: ``w_data`` (M, nnz_row) + the kernel tables
    of its layout, and ``tables_t``, which returns the tables of its
    transpose (built once by the owning module); it is called only when
    the input needs a gradient.  Stacked experts share one layout:
    ``w_data`` (E, M, nnz_row), ``b`` (E, M)."""

    w_data: torch.Tensor
    tables: KernelTables
    b: Optional[torch.Tensor] = None
    tables_t: Optional[Callable[[], TransposeTables]] = None


@dataclasses.dataclass
class QuantizedWeight:
    """int8 leaf-block storage of a compact or chain container (weight-only
    PTQ): ``q_data`` int8 of the wrapped ``w_data``'s shape, ``scales``
    float32 (..., M/G, S), one per (G, C) leaf block, ``b`` the bias in
    full precision, the wrapped container's kernel ``tables`` (which give
    (G, C)), ``kind`` ('compact' | 'chain') and ``orig_dtype``, the value
    dtype ``dequantize`` returns by default."""

    q_data: torch.Tensor
    scales: torch.Tensor
    tables: Union[KernelTables, ChainTables]
    b: Optional[torch.Tensor] = None
    kind: str = "compact"
    orig_dtype: torch.dtype = torch.float32

    def dequantize(self, dtype=None) -> Union[CompactWeight, ChainWeight]:
        """The wrapped full-precision container."""
        from .quant import dequantize_block_values, leaf_block_dims

        G, C = leaf_block_dims(self.tables)
        w = dequantize_block_values(self.q_data, self.scales, G, C,
                                    dtype=dtype or self.orig_dtype)
        cls = ChainWeight if self.kind == "chain" else CompactWeight
        return cls(w_data=w, tables=self.tables, b=self.b)


SparseWeight = Union[DenseWeight, MaskedWeight, CompactWeight, ChainWeight,
                     QuantizedWeight]


# ---------------------------------------------------------------------------
# backend protocol + registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """Declared properties used for validation, filtering and ``auto``.

    needs_layout:    requires an RBGP4 layout's tables.
    compact_storage: consumes CompactWeight (a layer under it stores
                     compact values).
    chain_storage:   consumes ChainWeight (a deep product chain's blocked
                     values).
    grad_support:    differentiable; without it an input, bias or residual
                     that needs a gradient raises.
    platforms:       the ``torch.device`` types it runs on.
    epilogue:        fuses bias/activation/residual into the kernel
                     (implements ``linear_fused``); without it the
                     dispatchers apply them as torch ops.
    batched:         runs stacked expert weights (leading E dim) in one
                     call (implements ``linear_batched``).
    quant:           consumes QuantizedWeight (int8 leaf blocks + one
                     scale per leaf block).
    """

    needs_layout: bool = False
    compact_storage: bool = False
    chain_storage: bool = False
    grad_support: bool = True
    platforms: tuple[str, ...] = ("cpu", "cuda")
    epilogue: bool = False
    batched: bool = False
    quant: bool = False

    def supports_platform(self, platform: str) -> bool:
        return platform in self.platforms


@runtime_checkable
class SparseBackend(Protocol):
    """One way of running a sparse projection.

    ``linear`` is token-major (``x`` (..., K) -> (..., M)); ``matmul`` the
    feature-major product (``x`` (K, N) -> (M, N)).  Both take the values
    unbiased: the dispatchers add the bias.  Methods called only where
    the matching capability is declared:

      ``linear_fused(weight, x, *, fuse, residual)``  [epilogue] — bias,
        activation and residual inside the kernel.
      ``linear_batched(weight, x)``  [batched] — stacked experts, ``x``
        (E, N, K) -> (E, N, M); a backend with ``epilogue`` also takes
        ``fuse=`` and adds the bias itself.
    """

    name: str
    capabilities: BackendCapabilities
    accepts: tuple[type, ...]

    def linear(self, weight: SparseWeight,
               x: torch.Tensor) -> torch.Tensor: ...

    def matmul(self, weight: SparseWeight,
               x: torch.Tensor) -> torch.Tensor: ...


_REGISTRY: dict[str, SparseBackend] = {}


def register_backend(backend: SparseBackend, *, name: Optional[str] = None,
                     overwrite: bool = False) -> SparseBackend:
    """Register a backend instance under ``name`` (default:
    ``backend.name``)."""
    name = name or backend.name
    if name == "auto":
        raise ValueError("'auto' is reserved for dispatch-time selection")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    _REGISTRY[name] = backend
    return backend


def get_backend(name: str) -> SparseBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown sparse backend {name!r}; available: "
                       f"{sorted(_REGISTRY)}") from None


def available_backends(
    *,
    platform: Optional[str] = None,
    weight: Optional[Any] = None,
    needs_layout: Optional[bool] = None,
    compact_storage: Optional[bool] = None,
    chain_storage: Optional[bool] = None,
    grad_support: Optional[bool] = None,
    epilogue: Optional[bool] = None,
    batched: Optional[bool] = None,
    quant: Optional[bool] = None,
) -> list[str]:
    """Registered backend names, sorted, filtered by capability, platform
    (a ``torch.device`` type) and weight container (a type or an
    instance)."""
    flags = {"needs_layout": needs_layout, "compact_storage": compact_storage,
             "chain_storage": chain_storage, "grad_support": grad_support,
             "epilogue": epilogue, "batched": batched, "quant": quant}
    out = []
    for name, be in sorted(_REGISTRY.items()):
        caps = be.capabilities
        if platform is not None and not caps.supports_platform(platform):
            continue
        if any(want is not None and getattr(caps, flag) != want
               for flag, want in flags.items()):
            continue
        if weight is not None:
            wtype = weight if isinstance(weight, type) else type(weight)
            if not issubclass(wtype, be.accepts):
                continue
        out.append(name)
    return out


def storage_kind(backend: str, *, has_layout: bool,
                 chain: bool = False) -> str:
    """'compact', 'chain' or 'masked' storage for a sparsified layer given
    its backend name ('dense' is never returned).

    ``auto`` prefers compact storage whenever the pattern has an RBGP4
    layout, then chain storage for a deeper product chain, then masked.
    A named backend is looked up in the registry (an unknown name raises
    KeyError); one declaring ``chain_storage`` or ``compact_storage``
    requires the matching pattern and raises ValueError otherwise, and
    any other stores masked values.
    """
    if backend == "auto":
        if has_layout:
            return "compact"
        return "chain" if chain else "masked"
    caps = get_backend(backend).capabilities
    if caps.chain_storage:
        if not chain:
            raise ValueError(
                f"backend {backend!r} requires a >2-sparse-factor rbgp "
                f"chain (RBGP4-expressible patterns use compact storage)")
        return "chain"
    if caps.compact_storage:
        if not has_layout:
            raise ValueError(f"backend {backend!r} requires pattern=rbgp4 "
                             f"(compact storage is an RBGP property)")
        return "compact"
    return "masked"


def resolve_backend(weight: SparseWeight,
                    backend: str = "auto") -> SparseBackend:
    """The backend that runs ``weight``.

    ``auto``: QuantizedWeight -> quant; ChainWeight -> chain;
    CompactWeight -> pallas (on every device: the kernel wrapper runs its
    plain version on a CPU tensor); MaskedWeight -> xla_masked; anything
    else -> ref.  A named backend is checked against the weight's type
    (TypeError), except that a QuantizedWeight handed to a backend that
    does not accept it reroutes to ``quant``: plans written before
    quantization name the full-precision executor.
    """
    if backend == "auto":
        if isinstance(weight, QuantizedWeight):
            return get_backend("quant")
        if isinstance(weight, ChainWeight):
            return get_backend("chain")
        if isinstance(weight, CompactWeight):
            return get_backend("pallas")
        if isinstance(weight, MaskedWeight):
            return get_backend("xla_masked")
        return get_backend("ref")
    be = get_backend(backend)
    if not isinstance(weight, be.accepts):
        if isinstance(weight, QuantizedWeight) and "quant" in _REGISTRY:
            return get_backend("quant")
        raise TypeError(
            f"backend {be.name!r} accepts "
            f"{tuple(t.__name__ for t in be.accepts)}, got "
            f"{type(weight).__name__}")
    return be


# ---------------------------------------------------------------------------
# functional entry points
# ---------------------------------------------------------------------------

def _check_fuse(fuse: Optional[str]) -> None:
    if fuse is not None and fuse not in EPILOGUE_ACTS:
        raise ValueError(
            f"fuse {fuse!r} not a fusable activation "
            f"{sorted(EPILOGUE_ACTS)}; apply it outside sparse_linear"
        )


def _check_grad(be: SparseBackend, weight: SparseWeight, *tensors) -> None:
    if not be.capabilities.grad_support and needs_grad(weight.b, *tensors):
        hint = (", or train the full-precision container "
                "(dequantize_weights)" if be.capabilities.quant else "")
        raise RuntimeError(
            f"backend {be.name!r} is inference-only: it has no gradient; "
            f"run it under torch.no_grad(){hint}")


def sparse_linear(weight: SparseWeight, x: torch.Tensor, *,
                  backend: str = "auto", dtype=None,
                  fuse: Optional[str] = None,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = act(x @ W_s^T + b) + residual; x (..., K) token-major -> (..., M).

    ``fuse`` (a key of ``EPILOGUE_ACTS``) and ``residual`` run in the
    kernel's epilogue on a backend declaring ``epilogue``, and as torch
    ops after it otherwise.
    """
    _check_fuse(fuse)
    be = resolve_backend(weight, backend)
    _check_grad(be, weight, x, residual)
    dtype = dtype or x.dtype
    xc = x.to(dtype)
    if be.capabilities.epilogue and (
            fuse is not None or residual is not None or weight.b is not None):
        return be.linear_fused(weight, xc, fuse=fuse, residual=residual)
    y = be.linear(weight, xc)
    if weight.b is not None:
        y = y + weight.b.to(dtype)
    if fuse is not None:
        y = EPILOGUE_ACTS[fuse](y)
    if residual is not None:
        y = y + residual.to(dtype)
    return y


def sparse_linear_batched(weight: SparseWeight, x: torch.Tensor, *,
                          backend: str = "auto", dtype=None,
                          fuse: Optional[str] = None) -> torch.Tensor:
    """Stacked-expert linear: y[e] = act(x[e] @ W_s[e]^T + b[e]);
    x (E, ..., K) -> (E, ..., M).

    The containers' values carry a leading expert dim (``w_data`` (E, M,
    nnz_row) over one layout, ``w`` (E, M, K)); the bias is (E, M).  Runs
    the backend's ``linear_batched`` (pallas: one ``rbgp4mm_rhs_stacked``
    launch for all experts).
    """
    _check_fuse(fuse)
    be = resolve_backend(weight, backend)
    caps = be.capabilities
    if not caps.batched:
        raise NotImplementedError(
            f"backend {be.name!r} does not declare the 'batched' "
            f"capability; available: {available_backends(batched=True)}")
    _check_grad(be, weight, x)
    dtype = dtype or x.dtype
    e = x.shape[0]
    x3 = x.to(dtype).reshape(e, -1, x.shape[-1])
    if caps.epilogue:
        y = be.linear_batched(weight, x3, fuse=fuse)
    else:
        y = be.linear_batched(weight, x3)
        if weight.b is not None:
            y = y + weight.b.to(dtype)[:, None, :]
        if fuse is not None:
            y = EPILOGUE_ACTS[fuse](y)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def sparse_matmul(weight: SparseWeight, x: torch.Tensor, *,
                  backend: str = "auto", dtype=None) -> torch.Tensor:
    """O = W_s @ I (+ b per row); x (K, N) feature-major -> (M, N)."""
    be = resolve_backend(weight, backend)
    _check_grad(be, weight, x)
    dtype = dtype or x.dtype
    out = be.matmul(weight, x.to(dtype))
    if weight.b is not None:
        out = out + weight.b.to(dtype)[:, None]
    return out


def _unpack(col0: torch.Tensor, G: int, C: int, w_data: torch.Tensor,
            k: int) -> torch.Tensor:
    """Scatter compact values (..., M, nnz_row) to dense (..., M, K) through
    a ``col0`` table, whose rows ``rg*G + g`` read columns
    ``col0[rg, s] + c`` at slot ``s*C + c`` (RBGP4 and chain tables
    alike)."""
    c = torch.arange(C, dtype=torch.int64, device=col0.device)
    ci = (col0.to(torch.int64)[:, None, :, None] + c).expand(
        -1, G, -1, -1).reshape(w_data.shape[-2:])
    lead = w_data.shape[:-2]
    dense = torch.zeros((*lead, w_data.shape[-2], k), dtype=w_data.dtype,
                        device=w_data.device)
    return dense.scatter_(-1, ci.to(w_data.device).expand(*lead, -1, -1),
                          w_data)


def dense_weight(weight: SparseWeight, dtype=None) -> torch.Tensor:
    """The effective dense (M, K) matrix ((E, M, K) for stacked experts),
    zeros off the mask (tests, export)."""
    if isinstance(weight, QuantizedWeight):
        return dense_weight(weight.dequantize(), dtype)
    if isinstance(weight, DenseWeight):
        w = weight.w
    elif isinstance(weight, MaskedWeight):
        return weight.materialize(dtype)
    elif isinstance(weight, CompactWeight):
        d = weight.tables.dims
        w = _unpack(weight.tables.col0, d.group_rows, d.chunk_cols,
                    weight.w_data, d.k)
    elif isinstance(weight, ChainWeight):
        t = weight.tables
        w = _unpack(t.col0, t.group_rows, t.chunk_cols, weight.w_data, t.k)
    else:
        raise TypeError(f"not a weight container: {type(weight).__name__}")
    return w.to(dtype) if dtype is not None else w


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------

class RefBackend:
    """Dense materialization: correct for every container it accepts, and
    differentiable through autograd; (M, K) is materialized."""

    name = "ref"
    capabilities = BackendCapabilities(batched=True)
    accepts = (DenseWeight, MaskedWeight, CompactWeight)

    def linear(self, weight, x):
        return x @ dense_weight(weight, x.dtype).T

    def matmul(self, weight, x):
        return dense_weight(weight, x.dtype) @ x

    def linear_batched(self, weight, x):
        return torch.einsum("enk,emk->enm", x, dense_weight(weight, x.dtype))


class XlaMaskedBackend:
    """(W * mask) @ x: the paper-faithful predefined-sparsity training
    path."""

    name = "xla_masked"
    capabilities = BackendCapabilities(batched=True)
    accepts = (MaskedWeight,)

    def linear(self, weight, x):
        return x @ weight.materialize(x.dtype).T

    def matmul(self, weight, x):
        return weight.materialize(x.dtype) @ x

    def linear_batched(self, weight, x):
        # w (E, M, K); the (M, K) mask broadcasts over the experts
        return torch.einsum("enk,emk->enm", x, weight.materialize(x.dtype))


class XlaCompactBackend:
    """Gather + einsum from compact storage in plain torch, no dense W:
    the token-major products read ``col0`` alone, so a rank's share of a
    layout (``KernelTables.rank_slice``) runs them too; gradients through
    autograd."""

    name = "xla_compact"
    capabilities = BackendCapabilities(needs_layout=True,
                                       compact_storage=True, batched=True)
    accepts = (CompactWeight,)

    @staticmethod
    def _rhs(weight, x):
        d = weight.tables.dims
        return gather_mm_rhs_col0(weight.tables.col0, d.group_rows,
                                  d.chunk_cols, weight.w_data.to(x.dtype), x)

    def linear(self, weight, x):
        d = weight.tables.dims
        y = self._rhs(weight, x.reshape(-1, d.k))
        return y.reshape(*x.shape[:-1], d.m)

    def matmul(self, weight, x):
        t = weight.tables
        d = t.dims
        return gather_mm(t.adj_o, t.adj_i, d.n_col_tiles, d.group_rows,
                         d.chunk_cols, weight.w_data.to(x.dtype), x)

    def linear_batched(self, weight, x):
        return self._rhs(weight, x)


class PallasBackend:
    """The hand-written RBGP4 kernels (``kernels/ops.py``): ``rbgp4mm_rhs``
    with bias, activation and residual in its epilogue, one
    ``rbgp4mm_rhs_stacked`` launch for stacked experts and ``rbgp4mm`` for
    the feature-major product, with dX and dW on the kernels where a
    gradient is asked for.  On a CPU tensor each wrapper runs its plain
    version."""

    name = "pallas"
    capabilities = BackendCapabilities(
        needs_layout=True, compact_storage=True, platforms=("cpu", "cuda"),
        epilogue=True, batched=True)
    accepts = (CompactWeight,)

    def linear(self, weight, x):
        return compact_linear(weight.tables, x, weight.w_data.to(x.dtype),
                              tables_t=weight.tables_t)

    def linear_fused(self, weight, x, *, fuse=None, residual=None):
        b = weight.b.to(x.dtype) if weight.b is not None else None
        return compact_linear(
            weight.tables, x, weight.w_data.to(x.dtype), bias=b, fuse=fuse,
            residual=residual.to(x.dtype) if residual is not None else None,
            tables_t=weight.tables_t)

    def linear_batched(self, weight, x, *, fuse=None):
        b = weight.b.to(x.dtype) if weight.b is not None else None
        return compact_linear_stacked(weight.tables, x,
                                      weight.w_data.to(x.dtype), bias=b,
                                      fuse=fuse, tables_t=weight.tables_t)

    def matmul(self, weight, x):
        return compact_matmul(weight.tables, weight.w_data.to(x.dtype), x,
                              tables_t=weight.tables_t)


class ChainBackend:
    """Deep product chains: the ``chainmm_rhs`` kernel (dX and dW on
    ``chainmm_rhs`` and ``chain_sddmm_rhs`` where a gradient is asked
    for); the feature-major product densifies, as the reference's does.
    No epilogue and no stacked experts."""

    name = "chain"
    capabilities = BackendCapabilities(chain_storage=True)
    accepts = (ChainWeight,)

    def linear(self, weight, x):
        return chain_linear(weight.tables, x, weight.w_data.to(x.dtype),
                            tables_t=weight.tables_t)

    def matmul(self, weight, x):
        return dense_weight(weight, x.dtype) @ x


class QuantBackend:
    """Weight-only int8 storage (:class:`QuantizedWeight`).

    On a CUDA tensor: the ``scales=`` paths of ``rbgp4mm_rhs``,
    ``rbgp4mm_rhs_stacked`` and ``chainmm_rhs``, which dequantize each
    leaf block in registers.  On a CPU tensor, and for ``matmul`` on every
    device (there is no int8 feature-major kernel): the container is
    dequantized and handed to the backend ``auto`` picks for it, so the
    result is bit for bit that of the dequantized weights.  No epilogue
    (bias, activation and residual follow as torch ops, as on the
    dequantized path) and no gradient.
    """

    name = "quant"
    capabilities = BackendCapabilities(needs_layout=True, grad_support=False,
                                       batched=True, quant=True)
    accepts = (QuantizedWeight,)

    @staticmethod
    def _delegate(weight):
        # unbiased, as a backend's methods take it: the dispatcher adds
        # the bias after this backend, which declares no epilogue
        inner = dataclasses.replace(weight.dequantize(), b=None)
        return inner, resolve_backend(inner, "auto")

    def linear(self, weight, x):
        if x.device.type == "cpu":
            inner, be = self._delegate(weight)
            return be.linear(inner, x)
        t = weight.tables
        compact = weight.kind == "compact"
        m, k = (t.dims.m, t.dims.k) if compact else (t.m, t.k)
        run = rbgp4mm_rhs if compact else chainmm_rhs
        y = run(t, x.reshape(-1, k).contiguous(), weight.q_data,
                scales=weight.scales)
        return y.reshape(*x.shape[:-1], m)

    def linear_batched(self, weight, x):
        if weight.kind == "chain":
            raise NotImplementedError(
                "stacked-expert execution is compact-storage only (chain "
                "layers are not expert-stacked)")
        if x.device.type == "cpu":
            inner, be = self._delegate(weight)
            return be.linear_batched(inner, x)
        return rbgp4mm_rhs_stacked(weight.tables, x.contiguous(),
                                   weight.q_data, scales=weight.scales)

    def matmul(self, weight, x):
        inner, be = self._delegate(weight)
        return be.matmul(inner, x)


register_backend(RefBackend())
register_backend(XlaMaskedBackend())
register_backend(XlaCompactBackend())
register_backend(PallasBackend())
register_backend(ChainBackend())
register_backend(QuantBackend())
