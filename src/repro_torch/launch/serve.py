"""Serving driver of the port: a thin CLI over the continuous engine.

Runs on the card unless ``--device cpu`` is given; without CUDA and without
that flag it exits with an error naming the flag.

``--plan plan.json`` (a ``SparsityPlan`` written by ``SparsityPlan.save``,
by either package, or by ``repro_torch.launch.plan``) overrides
``--pattern``/``--sparsity``; the engine is given the plan, so with
``--max-live-tokens`` its admission budget grows by the weight bytes the
plan frees (plan-aware admission).

``--quant int8`` serves weight-only int8 storage (post-training
quantization): the plan's compact and chain rules are stamped with
``quant='int8'`` before the model is built (so its fingerprint names the
storage served), then every compact and chain projection is quantized to
int8 leaf blocks with one float32 scale each, which the int8 paths of the
kernels read on the card.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --mixed --requests 16 --prompt-len 512 --gen 64 --page-size 16
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --plan plan.json --max-live-tokens 64
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --quant int8
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import apply_sparsity, get_config, reduce_config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", default="continuous", choices=["continuous"],
                    help="continuous batching with a paged KV cache (the "
                         "only engine ported so far)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--batch", type=int, default=4, help="decode slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-length request workload (RequestStream) "
                         "instead of --batch identical requests")
    ap.add_argument("--requests", type=int, default=0,
                    help="number of requests (0: --batch)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per paged-KV block")
    ap.add_argument("--max-live-tokens", type=int, default=0,
                    help="admission budget: max sum(prompt+gen) over "
                         "running requests (0: pool capacity)")
    ap.add_argument("--pattern", default="rbgp4")
    ap.add_argument("--sparsity", type=float, default=0.75)
    ap.add_argument("--plan", default="",
                    help="SparsityPlan JSON; overrides --pattern/--sparsity "
                         "and is matched per module path")
    ap.add_argument("--quant", default="", choices=["", "int8"],
                    help="weight-only PTQ of the served weights: compact "
                         "and chain values as int8 leaf blocks + one f32 "
                         "scale each; the plan's succinct rules are "
                         "stamped quant=int8 (checkpoint fingerprints "
                         "refuse full-precision weights)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="",
                    help="write run stats (throughput, engine counters) to "
                         "this path as JSON")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="after the run, time this many decode steps with "
                         "every slot busy, then profile as many more "
                         "(torch.profiler, card only): wall time per step "
                         "against the card's kernel time")
    return ap


def profile_decode(model, workload, n_steps: int, *, page_size: int,
                   max_slots: int) -> dict:
    """Time ``n_steps`` decode steps of a fresh engine whose slots all hold
    a request, then profile ``n_steps`` more at the same load: host wall
    time per step, unprofiled and profiled, against the card's kernel time
    per step (kernel durations from torch.profiler's CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import (chainmm_rhs, rbgp4mm_rhs,
                                     rbgp4mm_rhs_stacked)
    from repro_torch.serve import ContinuousEngine

    reqs = workload[:max_slots]
    gen = 2 * n_steps + 2
    eng = ContinuousEngine(
        model, page_size=page_size, max_slots=max_slots,
        max_request_len=max(r["prompt"].shape[0] for r in reqs) + gen)
    for r in reqs:
        eng.submit(r["prompt"], gen)
    eng.step()        # admit + prefill every request, one decode step

    def timed_steps() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def launches():
        # forward launches, full-precision and int8 (--quant) alike
        return [k.launches + k.launches_q for k in
                (rbgp4mm_rhs, rbgp4mm_rhs_stacked, chainmm_rhs)]

    wall_plain = timed_steps()
    launches0 = launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = timed_steps()
    launches1 = launches()
    kernels: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + \
                e.time_range.elapsed_us() * 1e-3
    busy = sum(kernels.values())
    stacked = sum(v for k, v in kernels.items()
                  if "rbgp4mm_rhs_stacked" in k)
    sparse = sum(v for k, v in kernels.items() if "rbgp4mm_rhs" in k) \
        - stacked
    chain = sum(v for k, v in kernels.items() if "chainmm_rhs" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {
        "steps": n_steps, "rows": len(reqs),
        "wall_ms_per_step_unprofiled": 1e3 * wall_plain / n_steps,
        "wall_ms_per_step": 1e3 * wall / n_steps,
        "device_busy_ms_per_step": busy / n_steps if busy else None,
        "device_idle_share": (1.0 - busy / (1e3 * wall)) if busy else None,
        "device_idle_share_unprofiled":
            (1.0 - busy / (1e3 * wall_plain)) if busy else None,
        "rbgp4mm_rhs_ms_per_step": sparse / n_steps if busy else None,
        "rbgp4mm_rhs_launches_per_step":
            (launches1[0] - launches0[0]) / n_steps,
        "rbgp4mm_rhs_stacked_ms_per_step":
            stacked / n_steps if busy else None,
        "rbgp4mm_rhs_stacked_launches_per_step":
            (launches1[1] - launches0[1]) / n_steps,
        "chainmm_rhs_ms_per_step": chain / n_steps if busy else None,
        "chainmm_rhs_launches_per_step":
            (launches1[2] - launches0[2]) / n_steps,
        "top_kernels_ms_per_step": {k: v / n_steps for k, v in top},
    }


def main(argv=None):
    args = build_parser().parse_args(argv)

    from repro_torch.data import RequestStream
    from repro_torch.device import resolve_device
    from repro_torch.models import LMModel
    from repro_torch.serve import RequestError, SamplingParams, make_engine
    from repro_torch.sparsity import (SparsityPlan, quantize_weights,
                                      weight_bytes)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.plan:
        cfg = apply_sparsity(cfg, plan=SparsityPlan.load(args.plan))
    elif args.sparsity > 0:
        cfg = apply_sparsity(cfg, pattern=args.pattern,
                             sparsity=args.sparsity, min_dim=64)
    if args.quant:
        # stamp quant on the succinct rules before the model resolves the
        # plan: the fingerprint must describe the storage served
        cfg = apply_sparsity(cfg, plan=cfg.sparsity_rules.with_quant(
            args.quant))
    model = LMModel(cfg, device=device, seed=args.seed)
    if args.quant:
        quantize_weights(model)
        wb = weight_bytes(model)
        print(f"weight-only PTQ: compact/chain values -> {args.quant} leaf "
              f"blocks + per-leaf-block f32 scales; plan "
              f"{cfg.sparsity_rules.fingerprint()}; stored bytes: values "
              f"{wb['values']:,}, scales {wb['scales']:,}, other "
              f"{wb['other']:,}")
    plan = cfg.sparsity_rules
    sp_desc = (f"plan={plan.fingerprint()} ({len(plan.rules)} rules)"
               if cfg.plan is not None else
               f"pattern={cfg.sparsity.pattern}@{cfg.sparsity.sparsity}")
    print(f"arch={cfg.name} params={model.n_params():,} {sp_desc} "
          f"engine={args.engine} device={device}")

    n_req = args.requests or args.batch
    if args.mixed:
        pl = tuple(sorted({max(4, args.prompt_len // d) for d in (4, 2, 1)}))
        gl = tuple(sorted({max(2, args.gen // d) for d in (8, 4, 2, 1)}))
    else:
        pl, gl = (args.prompt_len,), (args.gen,)
    workload = RequestStream(cfg.vocab_size, n_req, prompt_lens=pl,
                             gen_lens=gl, seed=args.seed).requests()
    max_len = max(r["prompt"].shape[0] + r["max_new_tokens"]
                  for r in workload)
    engine = make_engine(
        "continuous", model, page_size=args.page_size, max_slots=args.batch,
        max_live_tokens=args.max_live_tokens, max_request_len=max_len,
        plan=cfg.plan,  # plan-aware admission (None: uniform budget)
    )
    if args.max_live_tokens and cfg.plan is not None:
        print(f"plan-aware admission: max_live_tokens "
              f"{engine.base_live_tokens} -> {engine.plan_live_tokens} "
              f"(weight residency freed by the plan)")
    sampling = SamplingParams(temperature=args.temperature,
                              seed=args.seed + 1)

    t0 = time.perf_counter()
    for r in workload:
        try:
            engine.submit(r["prompt"], r["max_new_tokens"],
                          sampling=sampling, arrival_step=r["arrival_step"])
        except RequestError as e:
            print(f"rejected request ({e.reason}): {e}")
    out = engine.drain()
    wall = time.perf_counter() - t0

    st = engine.stats
    n_prompt = int(st["prompt_tokens"])
    n_gen = int(st["generated_tokens"])
    print(f"served {len(out)} requests ({n_prompt} prompt + {n_gen} new "
          f"tokens) in {wall*1e3:.0f}ms end-to-end "
          f"({(n_prompt + n_gen)/max(wall, 1e-9):.0f} tok/s incl. "
          f"first-call set-up)")
    print(f"prefill: {n_prompt} tokens, {int(st['prefill_calls'])} calls "
          f"in {st['prefill_time_s']*1e3:.0f}ms")
    print(f"decode : {n_gen} tokens, {int(st['decode_steps'])} steps in "
          f"{st['decode_time_s']*1e3:.0f}ms "
          f"({n_gen/max(st['decode_time_s'], 1e-9):.0f} tok/s)")
    occ = st["allocated_block_steps"] / max(st["block_steps"], 1)
    print(f"paged KV: page={args.page_size} "
          f"peak {int(st['peak_allocated_blocks'])} blocks, "
          f"mean pool occupancy {occ:.1%}")
    prof = None
    if args.profile_steps:
        if device.type != "cuda":
            raise SystemExit("error: --profile-steps profiles the card; "
                             "run with --device cuda")
        prof = profile_decode(model, workload, args.profile_steps,
                              page_size=args.page_size, max_slots=args.batch)
        busy = prof["device_busy_ms_per_step"]
        if busy is None:
            print("profile: the profiler recorded no kernel time (device "
                  "busy share not measured)")
        else:
            print(f"profile: {prof['rows']} rows, {prof['steps']} decode "
                  f"steps each: "
                  f"{prof['wall_ms_per_step_unprofiled']:.2f} ms/step wall "
                  f"unprofiled, {prof['wall_ms_per_step']:.2f} profiled; "
                  f"card busy {busy:.2f} ms/step (profiled), idle share "
                  f"{prof['device_idle_share_unprofiled']:.1%} of the "
                  f"unprofiled step, {prof['device_idle_share']:.1%} of "
                  f"the profiled one; rbgp4mm_rhs "
                  f"{prof['rbgp4mm_rhs_ms_per_step']:.2f} ms/step over "
                  f"{prof['rbgp4mm_rhs_launches_per_step']:.0f} launches, "
                  f"rbgp4mm_rhs_stacked "
                  f"{prof['rbgp4mm_rhs_stacked_ms_per_step']:.2f} ms/step "
                  f"over "
                  f"{prof['rbgp4mm_rhs_stacked_launches_per_step']:.0f}, "
                  f"chainmm_rhs {prof['chainmm_rhs_ms_per_step']:.2f} "
                  f"ms/step over "
                  f"{prof['chainmm_rhs_launches_per_step']:.0f}")
            for name, ms in prof["top_kernels_ms_per_step"].items():
                print(f"  {ms:8.3f} ms/step  {name[:100]}")
    if args.json:
        payload = {
            "arch": cfg.name, "engine": args.engine, "device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "requests": len(engine.requests), "served": len(out),
            "wall_s": wall, "prompt_tokens": n_prompt,
            "generated_tokens": n_gen,
            "tok_per_s": (n_prompt + n_gen) / max(wall, 1e-9),
            "quant": args.quant or None, "weight_bytes": weight_bytes(model),
            "stats": {k: float(v) for k, v in st.items()},
            "profile": prof,
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.json}")
    if out:
        rid0 = min(out)
        print(f"sample continuation (req {rid0}): "
              f"{np.asarray(out[rid0]).ravel()[:8].tolist()}")


if __name__ == "__main__":
    main()
