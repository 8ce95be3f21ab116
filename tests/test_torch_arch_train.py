"""Phase 50's expectations on the host, with no card (``chip_smoke``'s
functions; models built on ``meta``).

* The body each launch of a full-width training step takes, for the eight
  other language models at their ``ARCH_TRAIN`` depths (4 x 512 tokens,
  bf16, remat): ``train_step_launches`` applies the path functions to
  each projection's tables and rows (forward and its recompute, dX on
  the transposed layout, dW; a MoE layer's experts at their capacity
  rows).  Its FMA launches are pinned: jamba's Mamba ``x`` projection,
  544 x 16384 at G 8, keeps the FMA body for the forward (``rhs_path``
  takes G in 16-128) and for dW (``sddmm_path`` needs G a multiple of
  16); its dX (transposed G 128, C 8) and every other launch take the
  tensor cores.  The same bodies come out of each distinct layout built
  on the host (rbgp4 at 0.75) with its transposed tables.
* The earlier training phases' expectations come out unchanged:
  tinyllama, qwen2-moe and the chain plan launch every projection's
  forward twice, dX and dW once, all on the tensor cores.
* Each ``ARCH_TRAIN`` depth's trainer state, reckoned on ``meta`` at 14
  bytes a value, leaves ``TRAIN_HEADROOM_GB`` of the card's 80 GB free;
  a cut depth is the deepest that does, keeps a MoE layer and the
  layer pattern.
"""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import KernelTables, rhs_path, sddmm_path
from repro_torch.models import LMModel
from repro_torch.models.moe import MoELayer

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
BF16 = torch.bfloat16
N_TOKENS = chip_smoke.ARCH_TRAIN_BATCH * chip_smoke.ARCH_TRAIN_SEQ
#: the FMA launches of one full-width training step, by arch: (role, m,
#: k, experts, rows) -> launches a step; none for the other archs
FMA = {"jamba-1.5-large-398b": {("forward", 544, 16384, 1, N_TOKENS): 6,
                                ("dw", 544, 16384, 1, N_TOKENS): 3}}


def meta_model(cfg):
    return LMModel(cfg, device="meta")


def structural_launches(model) -> dict:
    """A remat step's launches from the layer counts alone: forward and
    recompute, dX, dW of every compact projection and of each MoE
    layer's three stacked expert projections."""
    n_c = sum(1 for m in model.modules() if getattr(m, "mode", None)
              == "compact")
    n_s = 3 * sum(1 for m in model.modules()
                  if isinstance(m, MoELayer) and m.experts.compact)
    return chip_smoke.launches_of(forward=2 * n_c, dx=n_c, dw=n_c,
                                  stacked_forward=2 * n_s, stacked_dx=n_s,
                                  stacked_dw=n_s)


@pytest.mark.parametrize("arch", list(chip_smoke.ARCH_TRAIN))
def test_training_launch_bodies_at_full_width(arch):
    model = meta_model(chip_smoke.arch_train_config(arch))
    want, mma, fma = chip_smoke.train_step_launches(model, N_TOKENS)
    assert want == structural_launches(model)
    got = {(f["role"], f["m"], f["k"], f["experts"], f["rows"]):
           f["launches"] for f in fma}
    assert got == FMA.get(arch, {})
    assert sum(mma.values()) + sum(got.values()) == sum(want.values())
    # the same bodies from each distinct layout built on the host
    rows = {1: N_TOKENS}
    rows.update((m.moe.n_experts, m.capacity(N_TOKENS, False))
                for m in model.modules() if isinstance(m, MoELayer))
    fma_layouts = set()
    for lay in chip_smoke.arch_layouts(model, "static"):
        layout, n = lay["layout"], rows[lay["experts"]]
        fwd = KernelTables.build(layout, "cpu").dims
        t = KernelTables.build(layout.transpose_layout(), "cpu",
                               transposed=True).dims
        for role, dims, path in (("forward", fwd, rhs_path),
                                 ("dx", t, rhs_path),
                                 ("dw", fwd, sddmm_path)):
            if path(dims, n, BF16) == "fma":
                fma_layouts.add((role, lay["m"], lay["k"], lay["experts"],
                                 n))
    assert fma_layouts == set(FMA.get(arch, {}))


@pytest.mark.parametrize("name, cfg, n_tokens, want", [
    ("tinyllama", chip_smoke.main_config, 4096,
     dict(forward=308, dx=154, dw=154)),
    ("qwen2-moe", chip_smoke.moe_config, 2048,
     dict(forward=336, dx=168, dw=168, stacked_forward=144, stacked_dx=72,
          stacked_dw=72)),
    ("chain", chip_smoke.chain_config, 4096,
     dict(chain_forward=308, chain_dx=154, chain_dw=154)),
])
def test_earlier_training_phases_expectations_unchanged(name, cfg, n_tokens,
                                                        want):
    """Phases 6, 10 and 16: the launches their callers pass, every one on
    the tensor cores."""
    got, mma, fma = chip_smoke.train_step_launches(meta_model(cfg()),
                                                   n_tokens)
    assert got == chip_smoke.launches_of(**want)
    assert fma == []
    for family in ("", "stacked_", "chain_"):
        assert mma[family + "forward"] == (got[family + "forward"]
                                           + got[family + "dx"])
        assert mma[family + "dw"] == got[family + "dw"]


@pytest.mark.parametrize("arch", list(chip_smoke.ARCH_TRAIN))
def test_train_depth_fits_the_card(arch):
    full = get_config(arch)
    depth = chip_smoke.ARCH_TRAIN[arch]
    cfg = chip_smoke.arch_train_config(arch)
    _, state_gb = chip_smoke.train_state_gb(cfg)
    card, room = chip_smoke.TRAIN_CARD_GB, chip_smoke.TRAIN_HEADROOM_GB
    assert state_gb + room <= card
    assert cfg.layer_pattern == full.layer_pattern
    assert cfg.d_model == full.d_model and cfg.d_ff == full.d_ff
    if depth is None:
        assert cfg.n_layers == full.n_layers
        return
    assert cfg.n_layers == depth < full.n_layers
    deeper = chip_smoke.arch_train_config(arch, depth + 1)
    assert chip_smoke.train_state_gb(deeper)[1] + room > card
    assert any(isinstance(m, MoELayer) for m in meta_model(cfg).modules())
