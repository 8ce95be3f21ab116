"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Serves full-width RBGP4-sparse tinyllama-1.1b (22 layers, d_model 2048,
rbgp4 at 0.75) through ``repro_torch``'s continuous-batching engine, with
every sparse projection running the hand-written ``rbgp4mm_rhs`` CUDA
kernel.  Phases, each printing its own lines; any failure raises and the
script exits non-zero without the result line:

  1. build the kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
     process per source, all at once); print the card's name and power
     limit;
  2. hold the kernel against its plain PyTorch version on the card: the
     four full-width layouts, N in {1, 8, 512}, float32 and bfloat16, three
     epilogues (tolerance max|diff| <= 1e-5 * max|ref| in float32, reduction
     order only; <= 2e-2 * max|ref| in bfloat16, output rounding);
  3. time the kernel, its plain version and a dense ``F.linear`` yardstick
     (CUDA events, median of 30 launches after warm-up, weights cycled
     through more than the 50 MB L2 cache) beside the least time the card
     could take;
  4. drive the main path: 16 mixed requests (prompts 128/256/512, 8-64 new
     tokens) through ``ContinuousEngine``, 8 slots, 16-token pages, greedy,
     bf16 compute, f32 KV cache; the kernel's launch count must equal 154
     (22 layers x 7 projections) per prefill call and per decode step;
  5. float32 parity on the card: the engine's greedy streams against
     ``run_sequential`` on 4 requests (a flip is tolerated only at a near
     tie: top-2 logit gap < 1e-4 * max|logit|).

The line before the last is the JSON ``{"kernels": [...]}`` record; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOPS = 989e12           # dense bf16 tensor-core peak, data sheet
FULL_WIDTH = {"wq/wo": (2048, 2048), "wk/wv": (256, 2048),
              "gate/up": (5632, 2048), "down": (2048, 5632)}
# the seven projections of one decoder layer, by layout
LAYER_PROJECTIONS = {"wq/wo": 2, "wk/wv": 2, "gate/up": 2, "down": 1}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
L2_BYTES = 50 * 2**20


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------

def _hold_queue() -> None:
    """Keep the card busy while the host queues the timed launches, so the
    events time the card's work and not the host's launch rate."""
    torch.cuda._sleep(200_000_000)


def time_cuda(fn, n_iter: int = 30, n_warm: int = 5) -> float:
    """Median milliseconds per call of ``fn(i)`` (CUDA events)."""
    for i in range(n_warm):
        fn(i)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(n_iter + 1)]
    _hold_queue()
    ev[0].record()
    for i in range(n_iter):
        fn(i)
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1])
                             for i in range(n_iter))


def bound_ms(n: int, m: int, k: int, nnz_row: int, n_chunk_cols: int,
             group_rows: int, elem_bytes: int) -> tuple[float, str]:
    """Least time for Y (n, m) = X (n, k) . W_s^T: every input read once
    (X, the compact W, the int32 column table), Y written once, against the
    data-sheet memory rate; the 2*n*m*nnz_row operations the sparse product
    needs against the bf16 tensor-core peak.  The larger bounds it."""
    nbytes = ((n * k + m * nnz_row + n * m) * elem_bytes
              + (m // group_rows) * n_chunk_cols * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * n * m * nnz_row / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phases ------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build(verbose=True)
    log("build", f"nvcc built {sorted(built) or 'nothing (up to date)'} in "
                 f"{time.perf_counter() - t0:.1f}s (wall, all sources at once)")
    for name, (_, text) in built.items():
        for line in text.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                log("build", f"{name}: {line.strip()}")
    name = torch.cuda.get_device_name(0)
    smi = card_line()
    print(smi, flush=True)
    log("build", f"card {name!r}; nvidia-smi name, power.limit: {smi}")
    return smi


def full_width_layouts():
    from repro_torch.core import RBGP4Layout, design_rbgp4

    return {key: RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
            for key, (m, k) in FULL_WIDTH.items()}


def phase_check(layouts) -> float:
    from repro_torch.kernels import (KernelTables, rbgp4mm_rhs,
                                     rbgp4mm_rhs_reference)

    g = torch.Generator(device="cuda").manual_seed(1)
    max_abs = 0.0
    n_cases = 0
    for key, lay in layouts.items():
        tables = KernelTables.build(lay, "cuda")
        for n in (1, 8, 512):
            for dt in (torch.float32, torch.bfloat16):
                worst = 0.0
                for act, bias, res in ((None, False, False),
                                       ("silu", False, False),
                                       ("gelu", True, True)):
                    rnd = lambda *s: torch.randn(*s, device="cuda",
                                                 generator=g).to(dt)
                    x, w = rnd(n, lay.k), rnd(*lay.data_shape)
                    b = rnd(lay.m) if bias else None
                    r = rnd(n, lay.m) if res else None
                    before = rbgp4mm_rhs.launches
                    y = rbgp4mm_rhs(tables, x, w, bias=b, act=act,
                                    residual=r)
                    torch.cuda.synchronize()
                    if rbgp4mm_rhs.launches != before + 1:
                        raise AssertionError("launch counter did not move")
                    want = rbgp4mm_rhs_reference(tables, x, w, bias=b,
                                                 act=act, residual=r)
                    err = float((y.float() - want.float()).abs().max())
                    scale = float(want.float().abs().max())
                    if not (np.isfinite(err) and err <= TOL[dt] * scale):
                        raise AssertionError(
                            f"{key} N={n} {dt} act={act}: max|diff| {err} > "
                            f"{TOL[dt]} * max|ref| {scale}")
                    worst = max(worst, err / scale)
                    max_abs = max(max_abs, err)
                    n_cases += 1
                log("check", f"{key:8s} N={n:<4d} {str(dt):15s} "
                             f"max|diff|/max|ref| = {worst:.2e} (3 epilogues)")
    log("check", f"{n_cases} cases agree; max abs diff {max_abs:.3e}")
    return max_abs


def phase_times(layouts) -> dict:
    from repro_torch.kernels import (KernelTables, rbgp4mm_rhs,
                                     rbgp4mm_rhs_reference)
    from repro_torch.kernels.ref import unpack_dense

    g = torch.Generator(device="cuda").manual_seed(2)
    dt = torch.bfloat16
    rows = {}
    for key, lay in layouts.items():
        tables = KernelTables.build(lay, "cuda")
        dims = tables.dims
        m, k = lay.m, lay.k
        nnz = lay.data_shape[1]
        w_bytes = m * nnz * 2
        copies = max(2, -(-2 * L2_BYTES // w_bytes))
        ws = torch.randn((copies, m, nnz), device="cuda", generator=g).to(dt)
        dense_copies = max(2, -(-2 * L2_BYTES // (m * k * 2)))
        wd = torch.stack([unpack_dense(lay, ws[i % copies])
                          for i in range(dense_copies)])
        for n in (8, 512):
            x = torch.randn((n, k), device="cuda", generator=g).to(dt)
            t_kernel = time_cuda(lambda i: rbgp4mm_rhs(
                tables, x, ws[i % copies]))
            t_plain = time_cuda(lambda i: rbgp4mm_rhs_reference(
                tables, x, ws[i % copies]))
            t_lib = time_cuda(lambda i: F.linear(x, wd[i % dense_copies]))
            b, by = bound_ms(n, m, k, nnz, dims.d_o * dims.d_i,
                             dims.group_rows, 2)
            rows[(key, n)] = dict(ms=t_kernel, plain_ms=t_plain,
                                  library_ms=t_lib, bound_ms=b, bound_by=by)
            log("times", f"{key:8s} N={n:<4d} bf16: kernel {t_kernel:.4f} ms"
                         f", plain {t_plain:.4f} ms, F.linear dense "
                         f"{t_lib:.4f} ms, bound {b * 1e3:.2f} us ({by})")
        del ws, wd
    torch.cuda.empty_cache()
    return rows


def main_config(compute_dtype: str = "bfloat16"):
    from repro_torch.configs import apply_sparsity, get_config

    cfg = apply_sparsity(get_config("tinyllama-1.1b"), pattern="rbgp4",
                         sparsity=0.75, min_dim=64)
    return cfg.with_(compute_dtype=compute_dtype)


def phase_serve() -> dict:
    from repro_torch.data import RequestStream
    from repro_torch.kernels import rbgp4mm_rhs
    from repro_torch.models import LMModel
    from repro_torch.serve import ContinuousEngine

    cfg = main_config("bfloat16")
    t0 = time.perf_counter()
    model = LMModel(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    n_compact = sum(1 for mod in model.modules()
                    if getattr(mod, "mode", None) == "compact")
    per_pass = 7 * cfg.n_layers
    if n_compact != per_pass:
        raise AssertionError(f"{n_compact} compact projections, want "
                             f"{per_pass}")
    log("serve", f"{cfg.name}: {cfg.n_layers} layers, d_model "
                 f"{cfg.d_model}, {model.n_params():,} stored values "
                 f"({n_compact} compact rbgp4 projections), built in "
                 f"{time.perf_counter() - t0:.1f}s")
    reqs = RequestStream(cfg.vocab_size, 16, prompt_lens=(128, 256, 512),
                         gen_lens=(8, 16, 32, 64), seed=0).requests()
    max_len = max(r["prompt"].shape[0] + r["max_new_tokens"] for r in reqs)
    kw = dict(page_size=16, max_slots=8, max_request_len=max_len,
              cache_dtype=torch.float32)
    # warm-up (cuBLAS handles, allocator), not counted
    warm = ContinuousEngine(model, **kw)
    warm.submit(reqs[0]["prompt"][:32], 2)
    warm.drain()
    del warm
    engine = ContinuousEngine(model, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rbgp4mm_rhs.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r["prompt"], r["max_new_tokens"])
    out = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rbgp4mm_rhs.launches
    st = engine.stats
    for r in reqs:
        toks = np.asarray(out[r["rid"]])
        if toks.shape != (r["max_new_tokens"],):
            raise AssertionError(f"request {r['rid']}: {toks.shape} tokens, "
                                 f"want {r['max_new_tokens']}")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r['rid']}: token out of range")
    passes = st["prefill_calls"] + st["decode_steps"]
    if launches != per_pass * passes or launches == 0:
        raise AssertionError(f"{launches} kernel launches for {passes} "
                             f"passes; want {per_pass} per pass")
    n_prompt, n_gen = st["prompt_tokens"], st["generated_tokens"]
    res = dict(
        requests=len(out), prompt_tokens=n_prompt, generated_tokens=n_gen,
        wall_s=wall, tok_per_s=(n_prompt + n_gen) / wall,
        prefill_calls=st["prefill_calls"], decode_steps=st["decode_steps"],
        prefill_time_s=st["prefill_time_s"],
        decode_time_s=st["decode_time_s"],
        decode_tok_per_s=n_gen / st["decode_time_s"],
        peak_allocated_blocks=st["peak_allocated_blocks"],
        launches=launches, launches_per_pass=launches / passes,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    )
    log("serve", f"served {len(out)} requests: {n_prompt} prompt + {n_gen} "
                 f"new tokens in {wall:.3f}s = {res['tok_per_s']:.1f} tok/s")
    log("serve", f"prefill {st['prefill_calls']} calls in "
                 f"{st['prefill_time_s']:.3f}s; decode {st['decode_steps']} "
                 f"steps in {st['decode_time_s']:.3f}s "
                 f"({res['decode_tok_per_s']:.1f} tok/s, "
                 f"{1e3 * st['decode_time_s'] / st['decode_steps']:.2f} "
                 f"ms/step)")
    log("serve", f"rbgp4mm_rhs launches {launches} = {per_pass} x "
                 f"{passes} passes; peak {st['peak_allocated_blocks']} "
                 f"blocks; peak memory {res['peak_mem_gb']:.2f} GB")
    print("serve " + json.dumps(res), flush=True)
    del model, engine
    torch.cuda.empty_cache()
    return res


def phase_parity() -> None:
    from repro_torch.data import RequestStream
    from repro_torch.models import LMModel
    from repro_torch.serve import ContinuousEngine, run_sequential

    cfg = main_config("float32")
    model = LMModel(cfg, device="cuda", seed=0)
    reqs = RequestStream(cfg.vocab_size, 4, prompt_lens=(128, 256, 512),
                         gen_lens=(8, 16, 32, 64), seed=1).requests()
    max_len = max(r["prompt"].shape[0] + r["max_new_tokens"] for r in reqs)
    engine = ContinuousEngine(model, page_size=16, max_slots=8,
                              max_request_len=max_len,
                              cache_dtype=torch.float32)
    for r in reqs:
        engine.submit(r["prompt"], r["max_new_tokens"])
    got = engine.drain()
    want = run_sequential(model, reqs, cache_len=engine.gather_tokens)
    flips = 0
    for r in reqs:
        a, b = np.asarray(got[r["rid"]]), np.asarray(want[r["rid"]])
        if np.array_equal(a, b):
            continue
        t = int(np.flatnonzero(a != b)[0])
        prefix = np.concatenate([r["prompt"], a[:t]]).astype(np.int32)
        logits, _ = model.prefill(prefix[None],
                                  model.init_cache(1, len(prefix),
                                                   torch.float32))
        top = torch.topk(logits[0].float(), 2)
        gap = float(top.values[0] - top.values[1])
        scale = float(logits[0].abs().max())
        pair = {int(a[t]), int(b[t])}
        if gap < 1e-4 * scale and pair <= set(top.indices.tolist()):
            flips += 1
            log("parity", f"request {r['rid']}: near-tie flip at token {t} "
                          f"(top-2 gap {gap:.3e} < 1e-4 x {scale:.3e})")
            continue
        raise AssertionError(
            f"request {r['rid']}: engine and run_sequential differ at token "
            f"{t} ({a[t]} vs {b[t]}; top-2 gap {gap:.3e}, max|logit| "
            f"{scale:.3e})")
    log("parity", f"float32 engine vs run_sequential: {len(reqs)} requests, "
                  f"{sum(len(v) for v in got.values())} tokens, "
                  f"{flips} near-tie flips")
    del model, engine
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    smi = phase_build()
    layouts = full_width_layouts()
    max_abs = phase_check(layouts)
    times = phase_times(layouts)
    serve = phase_serve()
    phase_parity()

    # the kernel record: one decoder layer's seven projections at decode
    # (N = 8 rows, bf16), the shape the main path launches most
    agg = {f: 0.0 for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
    for key, count in LAYER_PROJECTIONS.items():
        for f in agg:
            agg[f] += count * times[(key, 8)][f]
    bound_by = ("bytes" if all(times[(key, 8)]["bound_by"] == "bytes"
                               for key in LAYER_PROJECTIONS)
                else "operations")
    per_layout = {f"{key} N={n}": row for (key, n), row in times.items()}
    print("kernel_times " + json.dumps(per_layout), flush=True)
    record = {"kernels": [{
        "name": "rbgp4mm_rhs", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rbgp4mm_rhs.cu",
        "replaces": "src/repro/kernels/rbgp4mm.py:500",
        "launches": serve["launches"], "max_abs_err": max_abs,
        "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"], "bound_by": bound_by,
        "library_ms": agg["library_ms"],
        "work": "one decoder layer at decode: wq, wk, wv, wo, gate, up, "
                "down with 8 token rows, bf16",
    }]}
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f}s "
                f"on {smi}")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
