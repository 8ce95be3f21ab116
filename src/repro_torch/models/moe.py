"""Mixture-of-Experts FFN: token-choice top-k routing with capacity.

The port of ``repro/models/moe.py`` for one device: ``MoELayer`` routes
as the reference's ``_route_pjit`` with one routing group (the reference
takes that path whenever no mesh is installed).  The manual ``shard_map``
expert-parallel path comes with the distribution slice.

Expert weights are stacked over the experts and share one RBGP4 layout
per projection shape (cloned-mask EP), in one of two storages:
``StackedExperts`` keeps compact (E, M, nnz_row) values (backend
``auto``) and runs each projection as ONE launch of the stacked kernel for
all experts (``sparse_linear_batched``), with the gate activation fused
into the kernel's epilogue; or, under a masked backend (``xla_masked``,
``ref``), dense (E, M, K) values under the one broadcast mask, E dense
masked products (the reference's default).  Where the pattern does not
apply to the expert shapes, the values are dense (E, M, K).

Routing is discrete: a near tie between the k-th and (k+1)-th router
probability decides which expert a token goes to.  The router weight is
therefore kept in float32 whatever the compute dtype, and its logits are
summed in float64 and rounded to float32, so that a token's logits do not
depend on how many other tokens share the call (a decode step with one
row routes as one with eight).
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import EPILOGUE_ACTS, KernelTables, TransposeTables
from repro_torch.sparsity import (CompactWeight, DenseWeight, MaskedWeight,
                                  QuantizedWeight, SparsityConfig,
                                  SparsityPlan, make_pattern,
                                  sparse_linear_batched, storage_kind)
from repro_torch.sparsity.quant import (dequantize_block_values,
                                        leaf_block_dims,
                                        quantize_block_values)
from .mlp import ACTS, GatedMLP

__all__ = ["StackedExperts", "MoELayer"]


class StackedExperts(nn.Module):
    """(E, ...) stacked gated-MLP expert weights: ``gate``, ``up`` (the
    in-projection, d_model -> d_expert) and ``down`` (d_expert ->
    d_model).

    Compact storage holds each projection's values as ``<proj>.w_data``
    (E, M, nnz_row) over one layout per side, drawn as the reference's
    ``compact_init(..., lead=(E,))`` (normal times sqrt(2 / nnz_per_row));
    masked storage holds ``<proj>.w`` (E, M, K) and the side's base-graph
    factors ``<proj>.ba_o``/``<proj>.ba_i`` (uint8 buffers, the
    reference's ``MaskedWeight`` fields), drawn with the He rule over the
    kept fan-in; dense storage holds ``<proj>`` (E, M, K), drawn with the
    He rule over the dense fan-in.  The layouts' kernel tables are built
    once on the module's device; the transposed ones (dX) at the first
    gradient.

    ``quantize_()`` stores compact values as the reference's weight-only
    int8 storage in place: each projection holds ``q_data`` (E, M,
    nnz_row) int8 and the ``scales`` buffer (E, M/G, S) float32 in place
    of ``w_data`` (``dequantize_()`` inverts it).
    """

    def __init__(self, n_experts: int, d_model: int, d_expert: int,
                 sparsity: Optional[Union[SparsityConfig,
                                          SparsityPlan]] = None,
                 act: str = "silu", *, name: str = "moe",
                 dtype=torch.float32, param_dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.name = name
        self.act = ACTS[act]
        self.fuse = act if act in EPILOGUE_ACTS else None
        if isinstance(sparsity, SparsityPlan):
            # both projections resolve at {name}.experts.in / .out and must
            # agree: the experts share one spec, as in the reference
            path_in, path_out = f"{name}.experts.in", f"{name}.experts.out"
            spec_in = sparsity.resolve(path_in, d_expert, d_model)
            spec_out = sparsity.resolve(path_out, d_model, d_expert)
            if spec_in != spec_out and (spec_in.is_sparse
                                        or spec_out.is_sparse):
                raise ValueError(
                    f"StackedExperts needs one spec for both expert "
                    f"projections, but the plan resolves {path_in!r} -> "
                    f"{spec_in} and {path_out!r} -> {spec_out}; write rules "
                    f"matching both paths identically")
            sparsity = spec_in.to_config()
        sparsity = sparsity or SparsityConfig()
        applies = (sparsity.applies_to(d_expert, d_model)
                   and sparsity.pattern != "dense")
        if applies and sparsity.pattern != "rbgp4":
            raise NotImplementedError(
                f"StackedExperts got sparsity pattern {sparsity.pattern!r}; "
                f"stacked expert weights support only 'rbgp4' (one mask "
                f"shared across the expert dim) or 'dense'; chains have no "
                f"stacked storage")
        # the storage follows the backend, as in SparseLinear
        self.storage = (storage_kind(sparsity.backend, has_layout=True)
                        if applies else "dense")
        self.compact = self.storage == "compact"
        self.masked = self.storage == "masked"

        def draw(shape, scale):
            w = torch.randn((n_experts, *shape), generator=generator,
                            device=device, dtype=torch.float32) * scale
            return nn.Parameter(w.to(param_dtype).to(dtype),
                                requires_grad=False)

        if self.masked:
            dens = 1.0 - sparsity.sparsity
            for proj, (m, k) in (("gate", (d_expert, d_model)),
                                 ("up", (d_expert, d_model)),
                                 ("down", (d_model, d_expert))):
                lay = make_pattern(sparsity, m, k).layout
                holder = nn.Module()
                holder.w = draw((m, k), (2.0 / (k * dens)) ** 0.5)
                for name, graph in (("ba_o", lay.graph_o),
                                    ("ba_i", lay.graph_i)):
                    holder.register_buffer(name, torch.as_tensor(
                        graph.biadjacency, device=device))
                holder.group_rows = lay.spec.group_rows
                holder.chunk_cols = lay.spec.chunk_cols
                setattr(self, proj, holder)
        elif self.compact:
            lay_in = make_pattern(sparsity, d_expert, d_model).layout
            lay_out = make_pattern(sparsity, d_model, d_expert).layout
            self.layouts = {"in": lay_in, "out": lay_out}
            self.tables = {side: KernelTables.build(lay, device)
                           for side, lay in self.layouts.items()}
            self._tables_t: dict[str, TransposeTables] = {}
            for proj, lay in (("gate", lay_in), ("up", lay_in),
                              ("down", lay_out)):
                scale = (2.0 / lay.spec.nnz_per_row) ** 0.5
                setattr(self, proj, nn.ParameterDict(
                    {"w_data": draw(lay.data_shape, scale)}))
        else:
            s_in, s_out = (2.0 / d_model) ** 0.5, (2.0 / d_expert) ** 0.5
            self.gate = draw((d_expert, d_model), s_in)
            self.up = draw((d_expert, d_model), s_in)
            self.down = draw((d_model, d_expert), s_out)

    def _transpose_tables(self, side: str) -> TransposeTables:
        tt = self._tables_t.get(side)
        if tt is None:
            tt = self._tables_t[side] = TransposeTables.build(
                self.layouts[side], self.tables[side].col0.device)
        return tt

    @property
    def quantized(self) -> bool:
        """Whether the compact values are stored as int8 leaf blocks."""
        return self.compact and hasattr(self.gate, "q_data")

    def _side(self, proj: str) -> str:
        return "out" if proj == "down" else "in"

    def quantize_(self, w_data: Optional[dict] = None) -> None:
        """Weight-only PTQ in place, every expert's leaf blocks scaled
        apart.  ``w_data`` ({proj: (E, M, nnz_row)} float32 masters) is
        quantized in place of the module's own values where given.  No-op
        when already quantized."""
        if not self.compact:
            raise TypeError("only compact expert storage quantizes; these "
                            "experts are dense")
        if self.quantized:
            return
        for proj in ("gate", "up", "down"):
            own = getattr(self, proj)["w_data"]
            src = (w_data or {}).get(proj)
            src = own.detach() if src is None else src.to(own.device)
            q, scales = quantize_block_values(
                src, *leaf_block_dims(self.tables[self._side(proj)]))
            holder = nn.Module()
            holder.q_data = nn.Parameter(q, requires_grad=False)
            holder.register_buffer("scales", scales)
            setattr(self, proj, holder)
        self.orig_dtype = own.dtype

    def dequantize_(self) -> None:
        """Invert ``quantize_`` (no-op when not quantized)."""
        if not self.quantized:
            return
        for proj in ("gate", "up", "down"):
            holder = getattr(self, proj)
            w = dequantize_block_values(
                holder.q_data, holder.scales,
                *leaf_block_dims(self.tables[self._side(proj)]),
                dtype=self.orig_dtype)
            setattr(self, proj, nn.ParameterDict(
                {"w_data": nn.Parameter(w, requires_grad=False)}))

    def weight(self, proj: str):
        """The stacked storage container of projection ``proj``."""
        if self.masked:
            h = getattr(self, proj)
            return MaskedWeight(w=h.w, ba_o=h.ba_o, ba_i=h.ba_i,
                                group_rows=h.group_rows,
                                chunk_cols=h.chunk_cols)
        if not self.compact:
            return DenseWeight(w=getattr(self, proj))
        side = self._side(proj)
        if self.quantized:
            holder = getattr(self, proj)
            return QuantizedWeight(q_data=holder.q_data,
                                   scales=holder.scales,
                                   tables=self.tables[side],
                                   orig_dtype=self.orig_dtype)
        return CompactWeight(
            w_data=getattr(self, proj)["w_data"], tables=self.tables[side],
            tables_t=lambda: self._transpose_tables(side))

    def forward(self, xe: torch.Tensor) -> torch.Tensor:
        """xe (E, C, D) -> (E, C, D): one stacked launch per projection."""
        g = sparse_linear_batched(self.weight("gate"), xe, fuse=self.fuse)
        if self.fuse is None:
            g = self.act(g)
        h = g * sparse_linear_batched(self.weight("up"), xe)
        return sparse_linear_batched(self.weight("down"), h)


class MoELayer(nn.Module):
    """Routed experts (+ optional shared experts) replacing the MLP."""

    def __init__(self, d_model: int, moe: MoEConfig,
                 sparsity: Optional[Union[SparsityConfig,
                                          SparsityPlan]] = None,
                 act: str = "silu", *, name: str = "moe", dtype=torch.float32,
                 param_dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if moe.router_dtype != "float32":
            raise ValueError(f"the router runs in float32, got router_dtype="
                             f"{moe.router_dtype!r}")
        self.moe = moe
        router = torch.randn((moe.n_experts, d_model), generator=generator,
                             device=device, dtype=torch.float32)
        # float32 whatever the compute dtype (see the module docstring)
        self.router = nn.Parameter(router * d_model ** -0.5,
                                   requires_grad=False)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  generator=generator)
        self.experts = StackedExperts(moe.n_experts, d_model, moe.d_expert,
                                      sparsity, act, name=name, **kw)
        self.shared: Optional[GatedMLP] = None
        if moe.n_shared:
            self.shared = GatedMLP(d_model, moe.d_expert * moe.n_shared,
                                   sparsity, act, name=f"{name}.shared", **kw)

    def capacity(self, n_tokens: int, full_capacity: bool) -> int:
        """Rows of each expert's buffer: every token at full capacity
        (serving), else ceil(T * k / E * capacity_factor)."""
        if full_capacity:
            return n_tokens
        moe = self.moe
        return max(int(math.ceil(n_tokens * moe.top_k / moe.n_experts
                                 * moe.capacity_factor)), 1)

    def route(self, x2: torch.Tensor):
        """Router probabilities (T, E) in float32 and the top-k (gates,
        expert ids), gates normalised to sum to one."""
        logits = (x2.double() @ self.router.double().T).float()
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, self.moe.top_k, dim=-1)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return probs, gates, idx

    @torch.no_grad()
    def topk_margin(self, x: torch.Tensor) -> float:
        """The smallest gap, over the tokens of x (..., D), between the
        k-th and (k+1)-th router probability: how near the routing is to a
        tie that float32 noise could flip."""
        probs, _, _ = self.route(x.reshape(-1, x.shape[-1]))
        top = torch.topk(probs, self.moe.top_k + 1, dim=-1).values
        return float((top[:, -2] - top[:, -1]).min())

    def forward(self, x: torch.Tensor, *, full_capacity: bool = False):
        """x (B, S, D) -> (y, aux_loss).

        ``full_capacity`` (serving) sizes the expert buffers so that no
        token is ever dropped, which keeps decoding independent of the
        batch; capacity-based dropping is a training-only trade.
        """
        moe = self.moe
        B, S, D = x.shape
        T = B * S
        E, K = moe.n_experts, moe.top_k
        x2 = x.reshape(T, D)
        probs, gates, idx = self.route(x2)
        C = self.capacity(T, full_capacity)

        # position in expert: a cumsum over the flattened (token, k) order;
        # (token, k) pairs at or past the capacity are dropped
        e_flat = idx.reshape(T * K)
        onehot = (e_flat[:, None] == torch.arange(E, device=x.device)).long()
        pos = torch.cumsum(onehot, dim=0) - 1
        pos_in_e = torch.gather(pos, 1, e_flat[:, None])[:, 0]
        keep = pos_in_e < C
        slot = torch.where(keep, e_flat * C + pos_in_e, 0)   # into (E*C)
        tok = torch.arange(T, device=x.device).repeat_interleave(K)
        contrib = torch.where(keep[:, None], x2[tok], 0).to(x.dtype)
        buf = torch.zeros((E * C, D), dtype=x.dtype, device=x.device)
        buf = buf.index_add(0, slot, contrib).reshape(E, C, D)

        out = self.experts(buf).reshape(E * C, D)
        got = torch.where(keep[:, None], out[slot], 0)
        y = (got.reshape(T, K, D) * gates[..., None].to(x.dtype)).sum(1)
        y = y.reshape(B, S, D)

        # Switch-style load-balance loss
        frac_tokens = (idx[:, 0, None] == torch.arange(
            E, device=x.device)).float().mean(0)
        aux = E * torch.sum(frac_tokens * probs.mean(0)) * moe.aux_loss_coef
        if self.shared is not None:
            y = y + self.shared(x)
        return y, aux
