"""Serving driver of the port: a thin CLI over the serving engines.

Runs on the card unless ``--device cpu`` is given; without CUDA and without
that flag it exits with an error naming the flag.

``--engine continuous`` (default) is continuous batching over a paged KV
cache; ``--engine static`` the fixed-batch baseline.  ``--prefill-chunk N``
feeds prompts in N-token chunks, one per step.  ``--arrival-rate`` submits
each request when its arrival step comes.  The robustness flags are the
reference's: ``--reserve prompt`` (oversubscribe the pool; preempt under
pressure), ``--deadline-steps``, ``--max-retries``, ``--max-idle-steps``,
and a seeded random fault schedule (``--fault-seed``, ``--fault-events``,
``--fault-horizon``).  ``--trace FILE`` writes a Perfetto trace of the
step timeline (check it with ``python -m repro_torch.obs.trace FILE``),
``--prom FILE`` the metrics in Prometheus text, ``--json FILE`` the run's
numbers with the lifecycle counters.

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
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --prefill-chunk 4 --reserve prompt --fault-seed 0 --trace /tmp/t.json
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --engine static
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
    ap.add_argument("--engine", default="continuous",
                    choices=["static", "continuous"],
                    help="continuous batching with a paged KV cache, or "
                         "the fixed-batch baseline (equal-prompt groups, "
                         "lockstep decode)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: feed admitted prompts in chunks "
                         "of this many tokens, at most one chunk per step "
                         "(0: single-shot prefill)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (continuous) / batch size (static)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-length request workload (RequestStream) "
                         "instead of --batch identical requests")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="mean requests per engine step (geometric inter-"
                         "arrival gaps); 0 = all requests arrive up front. "
                         "Continuous engine only: requests are submitted "
                         "as their arrival step is reached")
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
    ap.add_argument("--reserve", default="worst_case",
                    choices=["worst_case", "prompt"],
                    help="admission block reservation: worst_case never "
                         "preempts; prompt oversubscribes the pool and "
                         "preempts lowest-priority requests under pressure "
                         "(resumed by re-prefill)")
    ap.add_argument("--deadline-steps", type=int, default=0,
                    help="per-request deadline in engine steps; requests "
                         "EXPIRE (freeing their pages) past it (0: none)")
    ap.add_argument("--max-retries", type=int, default=32,
                    help="preemptions + fault restarts a request survives "
                         "before FAILED")
    ap.add_argument("--max-idle-steps", type=int, default=1000,
                    help="watchdog: consecutive no-progress steps with "
                         "work pending before EngineStallError")
    ap.add_argument("--fault-seed", type=int, default=-1,
                    help="seeded FaultSchedule.random applied to the engine "
                         "(capacity drops, alloc failures, delays, request "
                         "kills); -1 = no faults")
    ap.add_argument("--fault-events", type=int, default=6,
                    help="events in the random fault schedule")
    ap.add_argument("--fault-horizon", type=int, default=48,
                    help="last engine step a random fault can land on")
    ap.add_argument("--json", default="",
                    help="write run stats (throughput, engine counters, "
                         "lifecycle counters) to this path as JSON")
    ap.add_argument("--trace", default="",
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "engine step timeline (step/prefill/decode slices, "
                         "preemption/fault/COW instants) to this path; "
                         "check it with 'python -m repro_torch.obs.trace "
                         "FILE'")
    ap.add_argument("--prom", default="",
                    help="write the metrics registry in Prometheus text "
                         "exposition format to this path after the run")
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
    from repro_torch.device import resolve_device, synchronize
    from repro_torch.models import LMModel
    from repro_torch.obs import SCHEMA_VERSION, Recorder
    from repro_torch.serve import (TERMINAL_STATES, FaultSchedule,
                                   RequestError, SamplingParams, make_engine)
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
    workload = RequestStream(
        cfg.vocab_size, n_req, prompt_lens=pl, gen_lens=gl, seed=args.seed,
        arrival_rate=args.arrival_rate if args.engine != "static" else 0.0,
    ).requests()
    max_len = max(r["prompt"].shape[0] + r["max_new_tokens"]
                  for r in workload)

    faults = None
    if args.fault_seed >= 0:
        faults = FaultSchedule.random(args.fault_seed,
                                      horizon=args.fault_horizon,
                                      n_events=args.fault_events)
        print(f"fault schedule: seed={args.fault_seed} "
              f"{len(faults)} events over {faults.horizon} steps")

    # a Recorder is attached whenever an observability output is asked
    # for; otherwise the engine keeps the null recorder
    recorder = None
    if args.trace or args.prom or args.json:
        recorder = Recorder()

    if args.engine == "static":
        engine = make_engine("static", model, batch=args.batch,
                             recorder=recorder)
    else:
        engine = make_engine(
            "continuous", model, page_size=args.page_size,
            max_slots=args.batch, max_live_tokens=args.max_live_tokens,
            max_request_len=max_len, prefill_chunk=args.prefill_chunk,
            plan=cfg.plan,  # plan-aware admission (None: uniform budget)
            reserve=args.reserve, max_retries=args.max_retries,
            max_idle_steps=args.max_idle_steps, faults=faults,
            recorder=recorder,
        )
        if args.max_live_tokens and cfg.plan is not None:
            print(f"plan-aware admission: max_live_tokens "
                  f"{engine.base_live_tokens} -> {engine.plan_live_tokens} "
                  f"(weight residency freed by the plan)")
    sampling = SamplingParams(temperature=args.temperature,
                              seed=args.seed + 1)
    pending = sorted(workload, key=lambda r: r["arrival_step"])
    deadline = args.deadline_steps or None

    t0 = time.perf_counter()
    step = 0
    while pending or not engine.idle:
        while pending and pending[0]["arrival_step"] <= step:
            r = pending.pop(0)
            try:
                engine.submit(r["prompt"], r["max_new_tokens"],
                              sampling=sampling,
                              arrival_step=r["arrival_step"],
                              deadline_steps=deadline)
            except RequestError as e:
                print(f"rejected request ({e.reason}): {e}")
        engine.step()
        step += 1
    synchronize(device)
    out = {rid: req.tokens for rid, req in sorted(engine.finished.items())}
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
          f"({n_gen/max(st['decode_time_s'], 1e-9):.0f} tok/s, "
          f"{int(st['wasted_row_steps'])} wasted row-steps)")
    if args.engine != "static":
        occ = st["allocated_block_steps"] / max(st["block_steps"], 1)
        print(f"paged KV: page={args.page_size} "
              f"peak {int(st['peak_allocated_blocks'])} blocks, "
              f"mean pool occupancy {occ:.1%}")
        if args.prefill_chunk:
            print(f"chunked prefill: {int(st['prefill_chunks'])} chunks "
                  f"of {args.prefill_chunk} tokens")
    lifecycle = {k: int(st.get(k, 0)) for k in (
        "rejected", "expired", "cancelled", "failed", "preemptions",
        "fault_kills", "resumed_prefills", "fault_events",
        "fault_paused_steps")}
    if any(lifecycle.values()):
        print("lifecycle: " + " ".join(f"{k}={v}"
                                       for k, v in lifecycle.items() if v))
    spans_agg = None
    if recorder is not None and recorder.spans is not None:
        spans_agg = recorder.spans.aggregate()
        ttft, tpot = spans_agg["ttft_s"], spans_agg["tpot_s"]
        qs = spans_agg["queue_steps"]
        if ttft and tpot:
            print(f"spans: {spans_agg['requests']} requests, "
                  f"TTFT p50={ttft['p50']*1e3:.1f}ms "
                  f"p99={ttft['p99']*1e3:.1f}ms, "
                  f"TPOT p50={tpot['p50']*1e3:.2f}ms "
                  f"p99={tpot['p99']*1e3:.2f}ms, "
                  f"queue-steps p50={qs.get('p50', 0):.0f}")
        if spans_agg["preemptions"]:
            print(f"spans: {spans_agg['preemptions']} preemptions lost "
                  f"{spans_agg['lost_steps']} request-steps")
    prof = None
    if args.profile_steps:
        if args.engine != "continuous":
            raise SystemExit("error: --profile-steps profiles the "
                             "continuous engine")
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
        states: dict = {}
        for req in engine.requests.values():
            states[req.state] = states.get(req.state, 0) + 1
        payload = {
            "schema_version": SCHEMA_VERSION,
            "arch": cfg.name, "engine": args.engine, "device": str(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
            "requests": len(engine.requests), "served": len(out),
            "wall_s": wall, "prompt_tokens": n_prompt,
            "generated_tokens": n_gen,
            "tok_per_s": (n_prompt + n_gen) / max(wall, 1e-9),
            "quant": args.quant or None, "weight_bytes": weight_bytes(model),
            "reserve": args.reserve, "states": states,
            "all_terminal": all(r.state in TERMINAL_STATES
                                for r in engine.requests.values()),
            **lifecycle,
            "stats": {k: float(v) for k, v in st.items()},
            "metrics": recorder.registry.snapshot(),
            "spans": spans_agg,
            "profile": prof,
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.json}")
    if args.trace:
        recorder.trace.save(args.trace)
        print(f"wrote {args.trace} "
              f"(open in ui.perfetto.dev or chrome://tracing)")
    if args.prom:
        with open(args.prom, "w") as f:
            f.write(recorder.registry.render_prometheus())
        print(f"wrote {args.prom}")
    if out:
        rid0 = min(out)
        print(f"sample continuation (req {rid0}): "
              f"{np.asarray(out[rid0]).ravel()[:8].tolist()}")


if __name__ == "__main__":
    main()
