"""The paper's benchmark models: VGG19 (the CIFAR variant of Liu et al.) and
WideResNet-40-4, with every conv lowered to im2col + SDMM, so the sparsity
pattern applies to a conv's weight exactly as in the paper: W_s of shape
(C_out, C_in*kh*kw) times the unfolded input.

The port of ``repro/models/vision.py``.  The paper's protocol, "equal
sparsity in all layers except the first layer connected to input and the
final classifier layer", is a plan rule: ``vision_plan`` prepends a
keep-dense rule matching the input conv, the classifier and the WRN
shortcut projections, and every conv and the classifier resolve their
pattern by module path.  ``VisionConfig(plan=...)`` gives full per-layer
control.

Activations are NHWC, as in the reference.  A ``SparseConv2D`` is a
``SparseLinear`` over the patches: ``F.unfold`` gives the patches'
features in the order of ``jax.lax.conv_general_dilated_patches`` (input
channel major, then kernel row, then kernel column), so a weight loads
from the reference unpermuted.  The layer's product is token-major, (B·H·W,
C_out) = NHWC, the layout of ``rbgp4mm_rhs``; ``F.unfold`` wants NCHW.  So
each conv makes two activation copies, NHWC to NCHW before the unfold and
the patches (B, C·k·k, L) to token-major (B·L, C·k·k) after it; they are
explicit and counted in ``SparseConv2D.layout_copies``.

The models hold their weights (drawn from ``generator`` on ``device``, or
loaded from the reference with ``repro_torch.bridge.load_jax_vision_params``)
and run on the card unless ``device="cpu"`` is asked for.  The compute
dtype is ``dtype``, that of the held projection values; the batch norms
normalize in float32, with float32 affine parameters, and return the
compute dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.sparsity import (PatternSpec, PlanRule, SparseLinear,
                                  SparsityConfig, SparsityPlan)

__all__ = ["SparseConv2D", "BatchNorm", "VGG19", "WRNBlock", "WideResNet",
           "VisionConfig", "vision_plan", "KEEP_DENSE_PATHS", "VGG19_PLAN",
           "max_pool_2x2"]

#: the paper-protocol dense exceptions, as one path rule: the input conv
#: ("conv0" in VGG, "stem" in WRN), the classifier head ("fc"), and WRN
#: shortcut 1x1 projections ("g{g}b{b}.proj").
KEEP_DENSE_PATHS = r"stem|conv0|fc|.*\.proj"


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    name: str
    n_classes: int = 10
    sparsity: SparsityConfig = dataclasses.field(
        default_factory=SparsityConfig)
    plan: Optional[SparsityPlan] = None
    width: int = 4          # WRN width multiplier
    depth: int = 40         # WRN depth (6n + 4)


def vision_plan(cfg: VisionConfig) -> SparsityPlan:
    """The plan a vision model resolves against: ``cfg.plan`` if set, else
    ``cfg.sparsity`` lowered with the paper's keep-dense rule prepended."""
    if cfg.plan is not None:
        return cfg.plan
    return SparsityPlan(rules=(
        PlanRule(KEEP_DENSE_PATHS, PatternSpec(),
                 note="paper protocol: input conv + classifier (and WRN "
                      "shortcut projections) stay dense"),
        PlanRule(".*", PatternSpec.from_config(cfg.sparsity),
                 note="uniform (lowered VisionConfig.sparsity)"),
    ))


def _module_kw(device, dtype, generator) -> dict:
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return dict(device=device, dtype=dtype, generator=generator)


class SparseConv2D(SparseLinear):
    """k x k conv (stride s, padding (k-1)//2) as im2col + ``SparseLinear``
    over C_in*k*k features: the paper's SDMM formulation."""

    #: activation copies between NHWC and the unfold's layouts, two a call
    layout_copies = 0

    def __init__(self, c_in: int, c_out: int, k: int = 3, stride: int = 1,
                 sparsity=None, *, name: str = "conv", device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(c_in * k * k, c_out, sparsity, name=name,
                         device=device, dtype=dtype, generator=generator)
        self.c_in, self.c_out, self.k, self.stride = c_in, c_out, k, stride

    def patches(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C_in) -> token-major patches (B, H', W', C_in*k*k)."""
        B, H, W, _ = x.shape
        k, s = self.k, self.stride
        pad = (k - 1) // 2
        nchw = x.permute(0, 3, 1, 2).contiguous()
        cols = F.unfold(nchw, k, padding=pad, stride=s)  # (B, C*k*k, L)
        tokens = cols.transpose(1, 2).contiguous()
        SparseConv2D.layout_copies += 2
        h_out = (H + 2 * pad - k) // s + 1
        w_out = (W + 2 * pad - k) // s + 1
        return tokens.reshape(B, h_out, w_out, self.in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C_in) -> (B, H', W', C_out)."""
        return super().forward(self.patches(x))


class BatchNorm(nn.Module):
    """Batch-statistics normalization over every axis but the last.

    As the reference: the biased batch variance, ``rsqrt(var + 1e-5)``,
    and batch statistics whenever ``train`` or no ``state`` is given (the
    models pass none); with ``state`` ({"mean", "var"}, float32) and
    ``train`` the new state moves by ``momentum``.  Statistics, ``scale``
    and ``bias`` are float32 (the statistics float64 for a float64 input);
    the result has the input's dtype.  Returns (y, new_state)."""

    def __init__(self, dim: int, momentum: float = 0.9, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.dim = dim
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(dim, device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, device=device),
                                 requires_grad=False)

    def init_state(self) -> dict:
        dev = self.scale.device
        return {"mean": torch.zeros(self.dim, device=dev),
                "var": torch.ones(self.dim, device=dev)}

    def forward(self, x: torch.Tensor, state: Optional[dict] = None,
                train: bool = True):
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if train or state is None:
            axes = tuple(range(x.ndim - 1))
            mean = x32.mean(axes)
            var = x32.var(axes, unbiased=False)
            new_state = None
            if state is not None:
                m = self.momentum
                new_state = {"mean": m * state["mean"] + (1 - m) * mean,
                             "var": m * state["var"] + (1 - m) * var}
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        y = (x32 - mean) * torch.rsqrt(var + 1e-5)
        return (y * self.scale + self.bias).to(x.dtype), new_state


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2 x 2, stride 2 max pool of NHWC x.  ``F.max_pool2d`` on the
    channels-last view (no copy) sends a tied window's gradient to one
    element, as the reference's ``reduce_window`` max does."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# VGG19 (CIFAR variant of Liu et al.: 16 convs + classifier)
# ---------------------------------------------------------------------------

VGG19_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


class _VisionModel(nn.Module):
    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype of the held projection values (the classifier's bias
        is stored with them)."""
        return self.fc.b.dtype


class VGG19(_VisionModel):
    """x (B, 32, 32, 3) -> logits (B, n_classes); ``convs``, ``bns`` and
    ``fc`` as the reference's parameter tree."""

    def __init__(self, cfg: VisionConfig, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _module_kw(device, dtype, generator)
        self.cfg = cfg
        self.device = kw["device"]
        plan = vision_plan(cfg)
        convs, bns = [], []
        c_prev = 3
        for v in VGG19_PLAN:
            if v == "M":
                continue
            convs.append(SparseConv2D(c_prev, v, 3, 1, plan,
                                      name=f"conv{len(convs)}", **kw))
            bns.append(BatchNorm(v, device=self.device))
            c_prev = v
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        self.fc = SparseLinear(512, cfg.n_classes, plan, name="fc",
                               use_bias=True, **kw)

    def forward(self, x, train: bool = True) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device).to(self.compute_dtype)
        ci = 0
        for v in VGG19_PLAN:
            if v == "M":
                x = max_pool_2x2(x)
                continue
            x = self.convs[ci](x)
            x, _ = self.bns[ci](x, train=train)
            x = F.relu(x)
            ci += 1
        return self.fc(x.mean(dim=(1, 2)))


# ---------------------------------------------------------------------------
# WideResNet-40-4
# ---------------------------------------------------------------------------

class WRNBlock(nn.Module):
    """Pre-activation block: bn1-relu, conv1, bn2-relu, conv2, plus the
    shortcut (a 1x1 projection of the bn1-relu output where the stride or
    width changes, else the input)."""

    def __init__(self, c_in: int, c_out: int, stride: int, plan, name: str,
                 **kw):
        super().__init__()
        dev = kw["device"]
        self.bn1 = BatchNorm(c_in, device=dev)
        self.conv1 = SparseConv2D(c_in, c_out, 3, stride, plan,
                                  name=f"{name}.c1", **kw)
        self.bn2 = BatchNorm(c_out, device=dev)
        self.conv2 = SparseConv2D(c_out, c_out, 3, 1, plan,
                                  name=f"{name}.c2", **kw)
        self.proj = None
        if stride != 1 or c_in != c_out:
            self.proj = SparseConv2D(c_in, c_out, 1, stride, plan,
                                     name=f"{name}.proj", **kw)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        h, _ = self.bn1(x, train=train)
        h = F.relu(h)
        sc = self.proj(h) if self.proj is not None else x
        h = self.conv1(h)
        h, _ = self.bn2(h, train=train)
        h = F.relu(h)
        return self.conv2(h) + sc


class WideResNet(_VisionModel):
    """WRN-depth-width (the paper's 40-4), depth = 6n + 4: x (B, 32, 32, 3)
    -> logits (B, n_classes); ``stem``, ``blocks``, ``bn_f`` and ``fc`` as
    the reference's parameter tree."""

    def __init__(self, cfg: VisionConfig, *, device=None,
                 dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = _module_kw(device, dtype, generator)
        self.cfg = cfg
        self.device = kw["device"]
        plan = vision_plan(cfg)
        n = (cfg.depth - 4) // 6
        widths = [16, 16 * cfg.width, 32 * cfg.width, 64 * cfg.width]
        self.stem = SparseConv2D(3, widths[0], 3, 1, plan, name="stem", **kw)
        blocks = []
        c_prev = widths[0]
        for g, w in enumerate(widths[1:]):
            for b in range(n):
                stride = 2 if (g > 0 and b == 0) else 1
                blocks.append(WRNBlock(c_prev, w, stride, plan, f"g{g}b{b}",
                                       **kw))
                c_prev = w
        self.blocks = nn.ModuleList(blocks)
        self.bn_f = BatchNorm(c_prev, device=self.device)
        self.fc = SparseLinear(c_prev, cfg.n_classes, plan, name="fc",
                               use_bias=True, **kw)
        self.c_final = c_prev

    def forward(self, x, train: bool = True) -> torch.Tensor:
        x = torch.as_tensor(x, device=self.device).to(self.compute_dtype)
        x = self.stem(x)
        for b in self.blocks:
            x = b(x, train=train)
        x, _ = self.bn_f(x, train=train)
        return self.fc(F.relu(x).mean(dim=(1, 2)))
