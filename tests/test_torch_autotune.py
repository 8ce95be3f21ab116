"""The port's autotuner (``repro_torch.kernels.autotune``) against the
reference's, on the CPU.

  * The cache contract: one ``search_fn`` stub driven through both
    packages gives the same search counts in the reference's cases
    (round trip, distinct keys, value-dtype keys, plan-fingerprint scope,
    a stale v1 file, an unwritable path).
  * The model search: the reference's ``_search_model``, with its
    estimator and budget patched to the port's (H100 ``perf_model``,
    227 KB of shared memory in place of the VMEM budget), picks the
    port's block_n on a seeded sample of ``KernelDims``.
  * Rule mode (the card's default, keyed ``cuda-sm90``; 132 SMs stand in
    for the card) gives today's fixed rules' tiles, and the launch plans
    they imply, at every shape of ``PERF.md`` section 6, 171 rows an
    expert included.
  * The port's own keys: stacked kinds and transposed tables never share
    an entry; a corrupt or unbuilt entry is searched again; the memo on
    the tables costs one lookup and is invalidated by the generation;
    measured mode on the CPU raises; a failing obs hook never breaks a
    launch.
"""
import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import RBGP4Layout as JLayout
from repro.core import RBGP4Spec as JSpec
from repro.kernels import KernelDims as JDims
from repro.kernels import autotune as jat
from repro_torch.core import RBGP4Layout, RBGP4Spec
from repro_torch.kernels import (KernelDims, KernelTables, autotune,
                                 chain_rhs_tile_rows, chain_sddmm_path,
                                 chain_tables, fm_mma_tile, fm_path,
                                 fm_sddmm_path, fm_sddmm_plan, perf_model,
                                 rbgp4mm_rhs, rbgp4mm_rhs_stacked, rhs_path,
                                 sddmm_mma_plan, sddmm_path,
                                 stacked_mma_block_tokens,
                                 stacked_sddmm_mma_plan)
from repro_torch.kernels.chainmm import ChainTables, chain_sddmm_mma_plan

# the modules (the package re-exports functions of the same names)
trbgp = importlib.import_module("repro_torch.kernels.rbgp4mm")
tchain = importlib.import_module("repro_torch.kernels.chainmm")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)
SM = 132   # an H100 SXM's SMs, in place of the card's
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def isolated_caches(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE_MODE", raising=False)
    jat.set_cache_path(str(tmp_path / "reference.json"))
    autotune.set_cache_path(str(tmp_path / "port.json"))
    yield
    for at in (jat, autotune):
        at.set_plan_fingerprint(None)
        at.set_cache_path(None)


def make_spec(mod, m=64, k=64, G=4, C=4, ui=4, vi=4, sp_o=0.5, sp_i=0.5,
              seed=0):
    return mod(g_o=(m // (ui * G), k // (vi * C)), g_r=(G, C), g_i=(ui, vi),
               g_b=(1, 1), sp_o=sp_o, sp_i=sp_i, seed=seed)


def both_dims(**kw):
    """The same layout's KernelDims in each package: (reference, port)."""
    jd = JDims.from_layout(JLayout(make_spec(JSpec, **kw)))
    td = KernelDims.from_layout(RBGP4Layout(make_spec(RBGP4Spec, **kw)))
    assert [getattr(jd, f) for f in ("m", "k", "tile_m", "tile_k",
                                     "group_rows", "chunk_cols", "d_o",
                                     "d_i")] == \
        [getattr(td, f) for f in ("m", "k", "tile_m", "tile_k",
                                  "group_rows", "chunk_cols", "d_o", "d_i")]
    return jd, td


# -- the cache contract, counted through both packages ------------------------

def counting(at, calls, block_n=lambda calls: 256):
    def search(d, n, dtype, kind):
        calls.append((kind, dtype, n))
        return at.TuneResult(block_n(calls), "nm", 1.0, "model")
    return search


def case_round_trip(at, dims):
    calls = []
    s = counting(at, calls)
    out = [at.autotune(dims, 512, dtype="float32", kind="rhs",
                       platform="testplat", search_fn=s).block_n, len(calls)]
    out += [at.autotune(dims, 512, dtype="float32", kind="rhs",
                        platform="testplat", search_fn=s).block_n,
            len(calls)]
    with open(at.cache_path()) as f:
        disk = json.load(f)
    out.append(disk["schema"] == at.CACHE_SCHEMA)
    out.append(sorted(v["block_n"] for v in disk["entries"].values()))
    at.clear_memory_cache()
    out += [at.autotune(dims, 512, dtype="float32", kind="rhs",
                        platform="testplat", search_fn=s).block_n,
            len(calls)]
    return out


def case_distinct_keys(at, dims):
    calls = []
    s = counting(at, calls, lambda c: 128)
    for dtype in ("float32", "bfloat16"):
        for kind in ("rhs", "sddmm"):
            at.autotune(dims, 256, dtype=dtype, kind=kind,
                        platform="testplat", search_fn=s)
    out = [len(calls)]
    for n in (100, 128):  # one bucket
        at.autotune(dims, n, dtype="float32", kind="lhs",
                    platform="testplat", search_fn=s)
    return out + [len(calls)]


def case_value_dtype(at, dims):
    calls = []
    s = counting(at, calls, lambda c: 256 if len(c) == 1 else 128)
    kw = dict(dtype="float32", kind="rhs", platform="testplat", search_fn=s)
    r32 = at.autotune(dims, 512, **kw).block_n
    r8 = at.autotune(dims, 512, value_dtype="int8", **kw).block_n
    out = [r32, r8, len(calls)]
    out += [at.autotune(dims, 512, **kw).block_n,
            at.autotune(dims, 512, value_dtype="int8", **kw).block_n,
            at.autotune(dims, 512, value_dtype="float32", **kw).block_n,
            len(calls)]
    return out


def case_plan_scope(at, dims):
    calls = []
    s = counting(at, calls)
    kw = dict(dtype="float32", kind="rhs", platform="testplat", search_fn=s)
    at.autotune(dims, 512, **kw)
    out = [len(calls)]
    at.set_plan_fingerprint("fp123")
    at.autotune(dims, 512, **kw)
    out.append(len(calls))
    with open(at.cache_path()) as f:
        keys = sorted(json.load(f)["entries"])
    out.append([k.split("|")[0] for k in keys])
    at.clear_memory_cache()
    at.autotune(dims, 512, **kw)
    out.append(len(calls))
    at.set_plan_fingerprint(None)
    at.autotune(dims, 512, **kw)
    return out + [len(calls)]


def case_stale_v1(at, dims):
    path = at.cache_path()
    with open(path, "w") as f:
        json.dump({"rhs|testplat|whatever": {
            "block_n": 512, "grid_order": "nm", "score": 1.0,
            "source": "model"}}, f)
    at.clear_memory_cache()
    calls = []
    r = at.autotune(dims, 512, dtype="float32", kind="rhs",
                    platform="testplat",
                    search_fn=counting(at, calls, lambda c: 128))
    with open(path) as f:
        disk = json.load(f)
    return [len(calls), r.block_n, disk["schema"] == at.CACHE_SCHEMA,
            "rhs|testplat|whatever" in disk["entries"]]


def case_unwritable(at, dims):
    at.set_cache_path("/proc/definitely/not/writable/cache.json")
    calls = []
    s = counting(at, calls)
    kw = dict(dtype="float32", kind="rhs", platform="testplat", search_fn=s)
    out = [at.autotune(dims, 256, **kw).block_n, len(calls)]
    out += [at.autotune(dims, 256, **kw).block_n, len(calls)]
    at.clear_memory_cache()
    at.autotune(dims, 256, **kw)
    # the model search itself degrades too
    out.append(at.autotune(dims, 256, dtype="float32", kind="sddmm",
                           platform="testplat").block_n >= 128)
    return out + [len(calls)]


@pytest.mark.parametrize("case", [case_round_trip, case_distinct_keys,
                                  case_value_dtype, case_plan_scope,
                                  case_stale_v1, case_unwritable],
                         ids=lambda c: c.__name__[5:])
@pytest.mark.parametrize("seed", [1, 2])
def test_cache_contract_counts_match_reference(case, seed):
    jd, td = both_dims(seed=seed)
    assert case(autotune, td) == case(jat, jd)


def test_reference_and_v2_files_are_not_read(tmp_path, monkeypatch):
    """The port's default file is its own, ``$REPRO_AUTOTUNE_CACHE`` is
    honored, and a file of the reference's schema (2, no tiles) is stale
    to the port."""
    autotune.set_cache_path(None)
    jat.set_cache_path(None)
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    assert autotune.cache_path() != jat.cache_path()
    assert "repro-rbgp4-torch" in autotune.cache_path()
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "env.json"))
    assert autotune.cache_path() == str(tmp_path / "env.json")
    path = tmp_path / "v2.json"
    _, td = both_dims(seed=3)
    key = autotune._key("rhs", td, 512, "float32", "testplat",
                        body=autotune._body("rhs", td, 512, "float32",
                                            "float32"))
    path.write_text(json.dumps({"schema": 2, "entries": {key: {
        "block_n": 256, "grid_order": "nm", "us_estimate": 1.0,
        "source": "model"}}}))
    autotune.set_cache_path(str(path))
    calls = []
    autotune.autotune(td, 512, dtype="float32", kind="rhs",
                      platform="testplat",
                      search_fn=counting(autotune, calls, lambda c: 128))
    assert len(calls) == 1


# -- the model search against the reference's -----------------------------------

def _sample_dims(rng):
    G = int(rng.choice([1, 2, 4, 8, 16, 32]))
    C = int(rng.choice([1, 2, 4, 8, 16]))
    ui, vi = int(rng.choice([2, 4, 8])), int(rng.choice([2, 4, 8]))
    go = int(rng.choice([2, 4, 8]))
    # a 2 x 2 graph carries sparsity 0.5 at most
    sp_o = float(rng.choice([0.0, 0.5] + [0.75] * (go >= 4)))
    sp_i = float(rng.choice([0.0, 0.5] + [0.75] * (min(ui, vi) >= 4)))
    return dict(m=go * ui * G, k=go * vi * C, G=G, C=C, ui=ui, vi=vi,
                sp_o=sp_o, sp_i=sp_i, seed=int(rng.integers(100)))


def test_model_search_matches_reference_with_port_estimator(monkeypatch):
    monkeypatch.setattr(jat, "estimate_rbgp4mm_dims",
                        perf_model.estimate_rbgp4mm_dims)
    monkeypatch.setattr(jat, "VMEM_BUDGET_BYTES", autotune.SMEM_BUDGET_BYTES)
    rng = np.random.default_rng(0)
    checked = 0
    for _ in range(12):
        jd, td = both_dims(**_sample_dims(rng))
        for n in (8, 100, 4096, 65536):
            for dtype, vd in (("float32", None), ("bfloat16", None),
                              ("bfloat16", "int8")):
                assert (autotune.candidate_block_ns(td, n, dtype, vd)
                        == jat.candidate_block_ns(jd, n, dtype, vd))
                for kind in ("rhs", "sddmm", "lhs"):
                    want = jat._search_model(jd, n, dtype, kind, vd)
                    got = autotune._search_model(td, n, dtype, kind, vd)
                    assert got.block_n == want.block_n, (td, n, dtype, kind)
                    assert got.us_estimate == pytest.approx(
                        want.us_estimate, rel=1e-12)
                    checked += 1
    assert checked == 12 * 4 * 3 * 3


def test_cpu_launches_resolve_through_the_model_search():
    _, td = both_dims(m=64, k=128, C=8, vi=2, seed=4)
    tables = KernelTables.build(RBGP4Layout(make_spec(
        RBGP4Spec, m=64, k=128, C=8, vi=2, seed=4)), "cpu")
    x = torch.randn(24, 128)
    w = torch.randn(64, td.data_cols)
    rbgp4mm_rhs(tables, x, w)
    with open(autotune.cache_path()) as f:
        keys = list(json.load(f)["entries"])
    assert keys == [autotune._key("rhs", td, 32, "float32", "cpu",
                                  body="fma")]
    res = tables.__dict__["_tune"][("rhs", 24, torch.float32, None, 1)][1]
    assert res.source == "model" and res.tile is None
    assert res == autotune._search_model(td, 32, "float32", "rhs")


# -- rule mode: today's tiles at every shape of PERF.md section 6 ----------------

@pytest.fixture
def card(monkeypatch):
    """Rule mode as on the card: the slice plans read 132 SMs."""
    monkeypatch.setattr(trbgp, "_sm_count", lambda device: SM)
    monkeypatch.setattr(tchain, "_sm_count", lambda device: SM)


def rule(tables, kind, n, e=1, dt=BF16):
    res = autotune.autotune(tables.dims, n, dtype=str(dt)[6:], kind=kind,
                            platform="cuda-sm90", tables=tables,
                            n_experts=e)
    assert res.source == "rule" and res.n == n and res.experts == e
    assert res.us_estimate > 0
    return res.tile


def rbgp4_tables(layout):
    return (KernelTables.build(layout, "cpu"),
            KernelTables.build(layout.transpose_layout(), "cpu",
                               transposed=True))


def check_token_major(layout, n):
    """forward, dX and dW of the token-major kernels at N."""
    fwd, dx = rbgp4_tables(layout)
    for t in (fwd, dx):
        want = (128,) if rhs_path(t.dims, n, BF16) == "mma" else ()
        assert rule(t, "rhs", n) == want
    tile = rule(fwd, "sddmm", n)
    if sddmm_path(fwd.dims, n, BF16) == "mma":
        assert sddmm_mma_plan(fwd.dims, n, SM, tile=tile) == \
            sddmm_mma_plan(fwd.dims, n, SM)
    else:
        assert tile == ()


def check_stacked(layout, n, e=60):
    fwd, dx = rbgp4_tables(layout)
    for t in (fwd, dx):
        want = ((stacked_mma_block_tokens(n, t.transposed),)
                if rhs_path(t.dims, n, BF16) == "mma" else ())
        assert rule(t, "rhs_stacked", n, e) == want
    tile = rule(fwd, "sddmm_stacked", n, e)
    if sddmm_path(fwd.dims, n, BF16) == "mma":
        assert sddmm_mma_plan(fwd.dims, n, SM, e, tile) == \
            stacked_sddmm_mma_plan(fwd.dims, e, n, SM)
    else:
        assert tile == ()


def test_rule_mode_is_todays_tiles_at_tinyllama_and_conv_layouts(card):
    for layout in chip_smoke.full_width_layouts().values():
        for n in (8, 512, 4096):
            check_token_major(layout, n)
    convs = chip_smoke.conv_layouts()
    for m, k, n in chip_smoke.conv_shapes():
        check_token_major(convs[(m, k)], n)


def test_rule_mode_is_todays_tiles_at_the_moe_experts(card):
    for layout in chip_smoke.moe_layouts().values():
        for n in (8, 16, 77, 171, 256, 512):
            check_stacked(layout, n)
    # 171 rows an expert: the last 128-token tile would be under half full,
    # so the forward takes 64 tokens a block; 256 takes 128; dX always 64
    fwd, dx = rbgp4_tables(chip_smoke.moe_layouts()["gate/up"])
    assert rule(fwd, "rhs_stacked", 171, 60) == (64,)
    assert rule(fwd, "rhs_stacked", 256, 60) == (128,)
    assert rule(dx, "rhs_stacked", 256, 60) == (64,)


def test_rule_mode_is_todays_tiles_at_the_chain_layouts(card):
    for layout in chip_smoke.chain_layouts().values():
        fwd = ChainTables.build(layout, "cpu")
        dx = ChainTables.build(layout.transpose_layout(), "cpu",
                               transposed=True)
        for n in (8, 4096):
            for t in (fwd, dx):
                want = ((chain_rhs_tile_rows(t),)
                        if tchain.chain_rhs_path(t, n, BF16) == "mma" else ())
                assert rule(t, "chain_rhs", n) == want
            tile = rule(fwd, "chain_sddmm", n)
            if chain_sddmm_path(fwd, n, BF16) == "mma":
                assert chain_sddmm_mma_plan(fwd, n, SM, tile[1]) == \
                    chain_sddmm_mma_plan(fwd, n, SM)
            else:
                assert tile == ()


def test_rule_mode_is_todays_tiles_at_vgg19s_feature_major_layers(card):
    layouts = chip_smoke.fm_layouts()
    for m, k, n in set(chip_smoke.VGG19_SDMM):
        fwd, dx = rbgp4_tables(layouts[(m, k)])
        for t in (fwd, dx):
            want = (fm_mma_tile(t, n) if fm_path(t.dims, n, BF16) == "mma"
                    else ())
            assert rule(t, "lhs", n) == want
        tile = rule(fwd, "sddmm_lhs", n)
        assert fm_sddmm_path(fwd.dims, n, BF16) == "mma"
        assert fm_sddmm_plan(fwd.dims, n, SM, block_cols=tile[0]) == \
            fm_sddmm_plan(fwd.dims, n, SM)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b"])
def test_rule_mode_is_todays_tiles_at_the_budget_layouts(card, arch):
    _, shapes, plan = chip_smoke.budget_plan(arch)
    for e in chip_smoke.plan_layouts(arch, shapes, plan):
        if e["stacked"]:
            check_stacked(e["layout"], e["n"])
        else:
            check_token_major(e["layout"], e["n"])


def test_int8_and_fma_launches_have_one_candidate():
    tables, _ = rbgp4_tables(chip_smoke.full_width_layouts()["wq/wo"])
    assert autotune.candidate_tiles("rhs", tables, 8, BF16) == ((),)
    assert autotune.candidate_tiles("rhs", tables, 4096, torch.float32) \
        == ((),)
    assert autotune.candidate_tiles("rhs", tables, 4096, BF16,
                                    torch.int8) == ((),)
    assert autotune.candidate_tiles("rhs", tables, 4096, BF16) == ((128,),)


def test_candidate_tiles_are_the_built_tiles_rule_first():
    lay = chip_smoke.full_width_layouts()["wq/wo"]
    fwd, dx = rbgp4_tables(lay)
    c = fwd.dims.chunk_cols
    cands = autotune.candidate_tiles("sddmm", fwd, 4096, BF16)
    assert cands[0] == (next(b for b in (128, 64, 32, 16) if c % b == 0),
                        128)
    assert set(cands) == {(b, 128) for b in (128, 64, 32, 16) if c % b == 0}
    assert set(autotune.candidate_tiles("sddmm_stacked", fwd, 171, BF16)) \
        == set(trbgp.STACKED_SDDMM_TILES)
    assert set(autotune.candidate_tiles("rhs_stacked", fwd, 171, BF16)) == \
        {(64,), (128,)}
    fm = chip_smoke.fm_layouts()
    t = KernelTables.build(fm[(256, 2304)], "cpu")
    cands = autotune.candidate_tiles("lhs", t, 16384, BF16)
    assert cands[0] == fm_mma_tile(t, 16384)
    assert set(cands) == set(trbgp.FM_MMA_TILES)
    assert set(autotune.candidate_tiles("sddmm_lhs", t, 16384, BF16)) == \
        {(b, 64) for b in trbgp.FM_SDDMM_TILES}
    ct = chain_tables(chip_smoke.chain_layouts()["wq/wo"], "cpu")
    assert set(autotune.candidate_tiles("chain_rhs", ct, 4096, BF16)) == \
        {(32,), (64,)}
    assert autotune.candidate_tiles("chain_sddmm", ct, 4096, BF16) == \
        ((64, 2), (64, 1), (64, 4))


# -- the port's own keys, memo and guards -----------------------------------------

def test_stacked_kinds_and_transposed_tables_key_apart():
    """A square layout whose transposed tables have the forward's dims:
    forward, dX and the stacked forward (and its dX) are four entries, and
    the stacked forward's tile differs from its dX's at the same dims."""
    spec = make_spec(RBGP4Spec, m=64, k=64, G=16, C=16, ui=2, vi=2,
                     sp_o=0.5, sp_i=0.0, seed=5)
    lay = RBGP4Layout(spec)
    fwd = KernelTables.build(lay, "cpu")
    dx = KernelTables.build(lay, "cpu", transposed=True)
    assert fwd.dims == dx.dims
    x, w = torch.randn(256, 64), torch.randn(64, fwd.dims.data_cols)
    rbgp4mm_rhs(fwd, x, w)
    rbgp4mm_rhs(dx, x, w)
    rbgp4mm_rhs_stacked(fwd, x.reshape(4, 64, 64),
                        w.expand(4, -1, -1).contiguous())
    rbgp4mm_rhs_stacked(dx, x.reshape(4, 64, 64),
                        w.expand(4, -1, -1).contiguous())
    with open(autotune.cache_path()) as f:
        keys = sorted(json.load(f)["entries"])
    assert sorted(k.split("|")[0] for k in keys) == [
        "rhs", "rhs.t", "rhs_stacked", "rhs_stacked.t"]
    assert all(k.endswith("|e4") for k in keys if "stacked" in k)
    assert autotune.rule_tile("rhs_stacked", fwd, 256, BF16) == (128,)
    assert autotune.rule_tile("rhs_stacked", dx, 256, BF16) == (64,)


def test_corrupt_and_unbuilt_entries_are_searched_again(tmp_path):
    fwd, _ = rbgp4_tables(chip_smoke.full_width_layouts()["wq/wo"])
    d = fwd.dims
    calls = []
    s = counting(autotune, calls, lambda c: 128)
    key = autotune._key("sddmm", d, 4096, "bfloat16", "cuda-sm90",
                        body="mma")
    for entry in ({"block_n": 0, "grid_order": "zz"},
                  {"block_n": "x", "grid_order": "nm"},
                  {"block_n": 128, "grid_order": "nm", "tile": [48, 128]},
                  {"block_n": 128, "grid_order": "nm", "tile": "bad"}):
        path = tmp_path / f"c{len(calls)}.json"
        path.write_text(json.dumps({"schema": autotune.CACHE_SCHEMA,
                                    "entries": {key: entry}}))
        autotune.set_cache_path(str(path))
        before = len(calls)
        autotune.autotune(d, 4096, dtype="bfloat16", kind="sddmm",
                          platform="cuda-sm90", tables=fwd, search_fn=s)
        assert len(calls) == before + 1, entry
    # a built tile is a hit
    path = tmp_path / "good.json"
    path.write_text(json.dumps({"schema": autotune.CACHE_SCHEMA, "entries": {
        key: {"block_n": 512, "grid_order": "nm", "tile": [64, 128],
              "source": "measured", "n": 4096}}}))
    autotune.set_cache_path(str(path))
    before = len(calls)
    res = autotune.autotune(d, 4096, dtype="bfloat16", kind="sddmm",
                            platform="cuda-sm90", tables=fwd, search_fn=s)
    assert len(calls) == before and res.tile == (64, 128)


def test_memo_is_one_lookup_until_the_generation_moves(monkeypatch):
    fwd, _ = rbgp4_tables(chip_smoke.full_width_layouts()["wk/wv"])
    first = autotune.launch_tile(fwd, "rhs", 8, torch.float32)
    seen = []
    real = autotune.resolve

    def spy(*a, **kw):
        seen.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(autotune, "resolve", spy)
    assert autotune.launch_tile(fwd, "rhs", 8, torch.float32) is first
    assert not seen
    for bump in (autotune.clear_memory_cache,
                 lambda: autotune.set_plan_fingerprint("fp"),
                 lambda: autotune.set_cache_path(autotune.cache_path())):
        bump()
        autotune.launch_tile(fwd, "rhs", 8, torch.float32)
    assert len(seen) == 3


def test_measured_mode_on_the_cpu_raises(monkeypatch):
    fwd, _ = rbgp4_tables(chip_smoke.full_width_layouts()["wk/wv"])
    monkeypatch.setenv("REPRO_AUTOTUNE_MODE", "measure")
    autotune.clear_memory_cache()
    with pytest.raises(RuntimeError, match="measure"):
        rbgp4mm_rhs(fwd, torch.randn(4, fwd.dims.k),
                    torch.randn(fwd.dims.m, fwd.dims.data_cols))


def test_a_failing_obs_hook_never_breaks_a_launch():
    def boom(**kw):
        raise RuntimeError("hook")

    autotune.set_obs_hook(boom)
    try:
        fwd, _ = rbgp4_tables(chip_smoke.full_width_layouts()["wk/wv"])
        y = rbgp4mm_rhs(fwd, torch.ones(3, fwd.dims.k),
                        torch.ones(fwd.dims.m, fwd.dims.data_cols))
        assert y.shape == (3, fwd.dims.m)
    finally:
        autotune.set_obs_hook(None)
