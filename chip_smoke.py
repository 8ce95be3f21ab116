"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Serves and trains two models through ``repro_torch``, with every sparse
product on a hand-written CUDA kernel, RBGP4 at 0.75, ``min_dim=64``,
tinyllama again under a deep-chain plan, runs VGG19-CIFAR's sparse layers
through the feature-major product, trains the paper's two vision models,
and trains and serves budget-solved plans:

  * full-width tinyllama-1.1b (22 layers, d_model 2048, all 154 projections
    compact) on ``rbgp4mm_rhs`` (the forward, and dX on the layer's
    transposed layout) and ``rbgp4_sddmm_rhs`` (dW);
  * full-width qwen2-moe-a2.7b (24 layers, 60 routed experts of width
    1408, top-4, a shared expert of width 5632): attention and the shared
    expert on those two kernels, the routed experts stacked (60, M,
    nnz_row) over one layout per side on ``rbgp4mm_rhs_stacked`` (forward
    and dX, one launch for all experts) and ``rbgp4_sddmm_rhs_stacked``
    (dW);
  * full-width tinyllama-1.1b under the one-rule hierarchical-block plan
    of ``benchmarks/chain_executor.py`` (``rbgp`` at 0.875, ``min_dim``
    256): all 154 projections in chain storage on ``chainmm_rhs`` (forward,
    and dX on the transposed layouts) and ``chain_sddmm_rhs`` (dW);
  * the paper's feature-major SDMM O = W_s . I at the full width of
    VGG19-CIFAR's 15 sparse convs (the paper's Table 1 at batch 256),
    through ``sparse_matmul`` on ``rbgp4mm`` (O, and dI on the transposed
    layouts) and ``rbgp4_sddmm`` (dW);
  * weight-only int8 (post-training quantized) serving of the three
    language models, as ``launch/serve.py --quant int8`` serves them:
    every compact and chain projection in int8 leaf blocks with one f32
    scale each, on the int8 (``scales=``) paths of ``rbgp4mm_rhs``,
    ``rbgp4mm_rhs_stacked`` and ``chainmm_rhs``;
  * the paper's own models, VGG19-CIFAR and WRN-40-4 at full width,
    trained at batch 256 through ``Trainer``: dense, unstructured and
    block (4 x 4) at 0.75 in masked storage, and RBGP4 at 0.75 in compact
    storage, whose sparse convs (unfolded patches, token-major) run on
    ``rbgp4mm_rhs`` (forward, dX) and ``rbgp4_sddmm_rhs`` (dW);
  * budget-solved plans (the plan compiler, ``sparsity.solve_budget``):
    mixed sparsities per layer at a global density of 0.25, certified,
    checked at their new layouts, trained (tinyllama, VGG19-CIFAR,
    WRN-40-4) and served (tinyllama, with plan-aware admission).

Phases, each printing its own lines; any failure raises and the script
exits non-zero without the result line:

  1. build the kernels from ``src/repro_torch/kernels/csrc`` (nvcc, one
     process per source, all at once); print the card's name and power
     limit;
  2. hold each kernel against its plain PyTorch version on the card
     (tolerance max|diff| <= 1e-5 * max|ref| in float32, reduction order
     only; <= 2e-2 * max|ref| in bfloat16, output rounding), each case one
     counted launch.  tinyllama's four layouts: ``rbgp4mm_rhs`` at N in
     {1, 8, 16, 64, 77, 512, 1037} x {f32, bf16} x three epilogues; with
     ``save_preact`` (Y and Z) and on the transposed layouts at N in
     {16, 64, 77, 512, 1037, 4096}; ``rbgp4_sddmm_rhs`` at N in {8, 16, 64,
     77, 512, 1037, 4096}, each dW again and bit-equal.  In bf16 from N =
     16 on, ``rbgp4mm_rhs`` and ``rbgp4_sddmm_rhs`` take their tensor-core
     bodies (``rhs_path``, ``sddmm_path``; each log line names the body),
     so 77 and 1037 are ragged token tiles of those bodies.  qwen2-moe's
     two expert layouts with 60 experts: ``rbgp4mm_rhs_stacked`` at N in
     {8, 171, 512} rows an expert (decode, training, full-capacity prefill)
     x {f32, bf16} x three epilogues, with ``save_preact`` at N = 171 and
     512, on the transposed layouts at N = 171; ``rbgp4_sddmm_rhs_stacked``
     at N in {8, 16, 77, 171, 512} (bf16 from 16 rows on the tensor-core
     body, rerun bit-equal and, expert by expert, bit-equal to the
     unstacked launch of the stacked plan);
  3. time each kernel, its plain version and one PyTorch call computing
     the same function (dense ``F.linear``/matmul on the unpacked weights;
     ``torch.bmm`` for the stacked experts) with CUDA events (median of 30
     launches after warm-up, operands cycled through more than the 50 MB
     L2 cache), beside the least time the card could take: the forward at
     N = 8 and 512, and a training step's calls at N = 4096 (the forward
     with ``save_preact``, dX and dW), each also on its FMA body on the
     same operands (``fma_ms``, the tensor-core bodies' yardstick); the
     stacked forward at 8, 171 (``save_preact``) and 512 rows an expert
     and dX and dW at 171, each tensor-core launch beside its FMA body
     and, at 171, beside each token tile (``mma64_ms``, ``mma128_ms``);
     the stacked tile sweep: the stacked tensor-core body with 64- and
     128-token tiles at 16-512 rows an expert, each held against the
     plain version and the two bit-equal (the measurement behind
     ``stacked_mma_block_tokens``); the stacked dW sweep: its tensor-core
     body with each (block columns, stage tokens) of
     ``STACKED_SDDMM_TILES`` at 16-512 rows an expert, each held against
     the plain version (the measurement behind ``stacked_sddmm_tile``);
     and the body sweep: both bodies of
     the forward, dX and dW at tinyllama's four layouts, N in {8, 16, 32,
     64, 128, 256, 512}, each result held against the plain version first
     (the measurement behind ``MMA_MIN_TOKENS``);
  4. serve tinyllama: 16 mixed requests (prompts 128/256/512, 8-64 new
     tokens) through ``ContinuousEngine``, 8 slots, 16-token pages,
     greedy, bf16 compute, f32 KV cache; every prefill call and decode step
     launches ``rbgp4mm_rhs`` 154 times (22 layers x 7 projections);
  5. serve parity in float32: the engine's greedy streams against
     ``run_sequential`` on 4 requests (a flip is tolerated only at a near
     tie: top-2 logit gap < 1e-4 * max|logit|);
  6. train tinyllama: 6 steps of ``Trainer.run`` (sgdm, lr 3e-2, cosine,
     clip 1.0, remat on; bf16 compute over f32 master values) on
     ``TokenStream(seed=0)`` batches of 8 x 512 tokens, the last 5 timed;
     per step 154 ``rbgp4_sddmm_rhs`` launches and 462 ``rbgp4mm_rhs``
     launches: 308 on forward layouts (154 forward + 154 recomputed under
     remat) and 154 on transposed layouts (dX), each counted at its
     launch, and every one of them on the tensor-core bodies
     (``launches_mma``); finite losses and gradient norms; then one more
     step under torch.profiler, whose launches by kernel symbol (FMA and
     ``*_mma_kernel`` apart; the dW slice sums counted as no launch, their
     time given to dW) and by role must equal the counters (the window
     opens with 2000 spin kernels, the records a trace loses first; a
     trace that still lost a sparse launch is reported and taken again,
     up to 3 steps);
  7. train parity in float32: a 2-layer full-width model takes 2 steps on
     the card (the kernels) and 2 on the CPU (the plain versions) from the
     same weights and batch, without weight decay; losses within 1e-4
     relative; the SGD momentum, which then holds only the clipped
     gradients, within 1e-4 * max|ref| for every parameter; every updated
     parameter within 1e-4 * max|ref|;
  8. serve qwen2-moe as phase 4 (the same 16 requests; the experts at full
     capacity, every token in every expert's buffer, as the reference
     serves): every prefill call and decode step launches ``rbgp4mm_rhs``
     168 times (24 layers x attention 4 + shared expert 3) and
     ``rbgp4mm_rhs_stacked`` 72 times (24 x 3), a prefill's on the
     tensor-core body, a decode step's (8 rows an expert) on the FMA body;
  9. serve parity of qwen2-moe in float32 as phase 5, on those 16 requests;
 10. train qwen2-moe: 4 steps of 4 x 512 tokens as phase 6 (routing with
     capacity, 171 rows an expert), the last 3 timed, ce and aux finite;
     per step ``rbgp4mm_rhs`` 336 forward + recompute and 168 dX,
     ``rbgp4_sddmm_rhs`` 168, ``rbgp4mm_rhs_stacked`` 144 forward +
     recompute and 72 dX (all on ``rbgp4mm_rhs_stacked_mma_kernel``),
     ``rbgp4_sddmm_rhs_stacked`` 72 (all on
     ``rbgp4_sddmm_rhs_stacked_mma_kernel``); one profiled step;
 11. train parity of 2 full-width qwen2-moe layers as phase 7;
 12. check-chain: the deep-chain kernels against their plain versions, as
     phase 2, at tinyllama's four shapes under the hierarchical-block plan
     (complete 4x4, three Ramanujan factors, complete 8x8, at 0.875;
     leaves 8x8, 16x32, 32x16): ``chainmm_rhs`` at N in {1, 8, 16, 77,
     512, 1037, 4096} x {f32, bf16}, on the transposed layouts at N in
     {16, 77, 512, 1037, 4096}, ``chain_sddmm_rhs`` at N in {8, 16, 77,
     512, 1037, 4096} (bf16 from 16 on the tensor-core bodies over
     row-group classes), each dW and each bf16 forward and dX on the
     tensor-core body rerun bit-equal; and at the two smaller chains of
     the CPU tests (G = C = 1, and a 2x2 leaf);
 13. times-chain: as phase 3, the forward at N = 8 and 512, the forward,
     dX and dW at N = 4096, each of those three beside its FMA body on
     the same operands;
 14. serve-chain: tinyllama under that plan (all 154 projections chains),
     the 16 requests of phase 4: every prefill call and decode step
     launches ``chainmm_rhs`` 154 times and no RBGP4 kernel, a prefill's
     on the tensor-core body, a decode step's on the FMA body;
 15. parity-chain: its float32 streams against ``run_sequential`` on 4
     requests, as phase 5;
 16. train-chain: 6 steps of 8 x 512 tokens as phase 6, per step 308
     forward + recompute and 154 dX ``chainmm_rhs`` launches (all on
     ``chainmm_rhs_mma_kernel``) and 154 ``chain_sddmm_rhs`` (all on
     ``chain_sddmm_rhs_mma_kernel``); one profiled step;
 17. train-parity-chain: 2 full-width layers in float32, card against CPU,
     as phase 7;
 18. check-fm (run after phase 13): ``rbgp4mm`` and ``rbgp4_sddmm``
     against their plain versions, as phase 2, at VGG19-CIFAR's seven
     distinct sparse layouts and WRN-40-4's 64 x 144 (C = 2), f32 and
     bf16: the forward at N in {1, 16, 1000, 1037, 4096, 4104}, dI on the
     transposed layouts and dW at each N but 1, each dW again and
     bit-equal.  In bf16 at N = 16 (the least they take), 1000, 4096 and
     4104 (ragged 128-token tiles), O, dI and dW take their tensor-core
     bodies (``fm_path``, ``fm_sddmm_path``; each log line names the
     bodies) at the seven VGG19 layouts; N = 1 and 1037 (not a multiple
     of 8), float32 and WRN's C = 2 and transposed G = 2 keep the FMA
     bodies; every launch moves its tensor-core counter exactly then;
     then, in bf16 at N in {16, 1000, 4104}, the same at Table 1's other
     sparsities (0.5, 0.875, 0.9375), whose other G, C and class sizes
     take other tiles of ``fm_mma_tile``;
 19. times-fm (after phase 18): as phase 3, VGG19's eight distinct layer
     shapes (m, k, N = res^2 x 256) in bf16: the forward, dI and dW
     kernels, their FMA bodies on the same operands (``fma_ms``), their
     plain versions and one ``torch.matmul`` each on the dense weights
     (``W @ I``, ``W^T @ dO``, ``dO @ I^T``); at each of these shapes,
     the ones the main path gives the kernels, each kernel is first held
     against its plain version on the timed inputs (bf16 tolerance) and
     dW is rerun bit-equal; then fm-sweep: both bodies of O, dI and dW
     at those shapes, the tensor-core body at each built tile
     (``FM_MMA_TILES``: class rows, tokens, warps) and dW block
     (``FM_SDDMM_TILES``), each held against the plain version first (the
     measurement behind ``fm_mma_tile`` and ``fm_sddmm_tile``);
 20. sdmm-vgg19: the 15 sparse layers at batch 256, bf16, through
     ``sparse_matmul`` with autograd: the fenced ms of a forward and of a
     forward + backward (median of 3 passes after a warm-up), peak memory;
     every pass launches ``rbgp4mm`` 15 times on forward tables and 15 on
     transposed ones (dI), ``rbgp4_sddmm`` 15 times, and nothing else,
     all 45 on the tensor-core bodies (``launches_mma``, O and dI apart);
     then one pass under torch.profiler: the card's busy ms by kernel and
     its idle share of that same pass's fenced window (and, apart, of the
     median unprofiled pass);
 21. parity-fm: the same 15 layers in float32 at batch 2, O, dW and dI on
     the card (the FMA bodies: no tensor-core counter moves) against the
     CPU within 1e-5 * max|ref|;
 22. check-q: the int8 paths against their plain versions on the same
     int8 values and scales (tolerances of phase 2), each rerun bit-equal:
     ``rbgp4mm_rhs`` at tinyllama's four layouts and the CPU tests' small
     layout (G = 4, C = 8) at N in {1, 8, 512}; ``rbgp4mm_rhs_stacked`` at
     qwen2-moe's two expert layouts, 60 experts, 8, 128, 256 and 512 rows
     an expert (decode and the prefill of each serve prompt length);
     ``chainmm_rhs`` at the chain plan's four layouts and the two chains of
     the CPU tests (G = C = 1 and a 2x2 leaf) at N in {1, 8, 512}; f32 and
     bf16;
 23. times-q: as phase 3 at N = 8: each int8 kernel beside the same
     layout's bf16 kernel, the int8 plain version, one PyTorch call on the
     dequantized dense weights and the bound with 1-byte values and their
     scales;
 24. serve-q: tinyllama under ``--quant int8`` (its plan stamped
     ``quant='int8'``, ``quantize_weights``), phase 4's 16 requests: every
     prefill call and decode step launches the int8 ``rbgp4mm_rhs`` 154
     times and no full-precision sparse kernel; its numbers and stored
     bytes beside phase 4's;
 25. serve-q-moe: qwen2-moe the same way, beside phase 8's: per pass 168
     int8 ``rbgp4mm_rhs`` and 72 int8 ``rbgp4mm_rhs_stacked`` launches
     (none on a tensor-core body);
 26. serve-q-chain: tinyllama under the chain plan, beside phase 14's: per
     pass 154 int8 ``chainmm_rhs`` launches and no RBGP4 kernel;
 27. parity-q: in float32 on 4 requests, the int8 model's greedy streams
     against ``run_sequential`` on it and against the engine's streams
     after ``dequantize_weights`` (near ties as phase 5): full-width
     tinyllama, and qwen2-moe and the chain plan at 2 full-width layers;
 28. check-conv: ``rbgp4mm_rhs`` (forward, and dX on the transposed
     layouts) and ``rbgp4_sddmm_rhs`` against their plain versions (phase
     2's tolerances) at the 9 distinct (m, k, N) of VGG19-CIFAR's and
     WRN-40-4's sparse convs at 0.75 (``conv_shapes``), f32 and bf16, at N
     in {16, 1037, 4096} and each layer's own N at batch 256 (up to
     262144): every launch moves ``launches_mma`` exactly when ``rhs_path``
     / ``sddmm_path`` name the tensor-core body (C 8 and 2, transposed G 8
     and 2 keep the FMA bodies), every dW reruns bit-equal;
 29. times-conv: as phase 3 at those layouts and batch-256 N, bf16: the
     forward, dX and dW kernels, their FMA bodies, plain versions, one
     dense PyTorch product each, the bound; for the forward also the
     masked product (the unstructured baseline's ``sparse_linear``) and
     torch's own CSR and BSR (4 x 4) products on the unstructured and
     block masks (``torch.sparse.mm``, library calls the port never makes;
     float32 where torch refuses bf16, said so);
 30. train-vision: VGG19-CIFAR and WRN-40-4 at full width, 6 steps of 256
     ``GaussianClassImages(10, 256, seed=0)`` images (``Trainer`` with
     ``classifier_loss``, sgdm 0.9, wd 1e-4, the step schedule, clip 1.0;
     bf16 over f32 masters), the last 5 timed, for dense, unstructured,
     block and RBGP4 storage: ms/step, images/s, peak memory, layout copies,
     launches per step counted at each launch (RBGP4: each sparse conv's
     forward, dX and dW, 15 / 36 of each; on the tensor-core bodies
     ``VISION_MMA``, (15, 13, 13) and (35, 23, 23)), finite losses and
     gradient norms; one profiled step (card busy and idle share);
 31. parity-vision: float32 VGG19-CIFAR at batch 8, RBGP4 compact and the
     unstructured baseline: the first forward's logits within 1e-4 *
     max|ref| and 2 steps' losses within 1e-4 relative, card against CPU,
     and each sparse conv's dW and dX of the card's first backward
     against the CPU's product on the card's own recorded tensors within
     1e-4 * max|ref| (``ConvRecorder``);
 32. kd-protocol: ``examples/cifar_vgg_rbgp4.py``'s protocol at WRN-40-4's
     full width, batch 64, bf16: a dense teacher, then unstructured
     (masked) and RBGP4 (compact) students at 0.75 with KD alpha 0.5, 80
     steps each; held-out accuracies printed, finite losses held;
 33. plan: the plan compiler at full width, on the host: shape recording
     (``model_matmul_shapes``, built on ``meta``), ``solve_budget`` at
     ``target_density=0.25, min_dim=64`` and ``certify`` for
     tinyllama-1.1b, qwen2-moe-a2.7b, VGG19-CIFAR and WRN-40-4; the
     fingerprints, the rules, each sparse layout's (m, k, sparsity, G, C,
     d_o, d_i) and the bodies ``rhs_path`` / ``sddmm_path`` name for its
     forward, dX (``transpose_layout()``) and dW at the training N (rows
     an expert for the experts); fails unless every proper factor is
     within its bound;
 34. check-plan: at the 10 layouts of those plans no earlier phase holds,
     ``rbgp4mm_rhs`` (forward, dX) and ``rbgp4_sddmm_rhs``, or for
     qwen2-moe's experts the stacked pair with 60 experts, against their
     plain versions at phase 2's tolerances, f32 and bf16, at N in {16,
     1037, 4096} (16 and 171 rows an expert): ``launches_mma`` moves
     exactly as the path functions name, every dW reruns bit-equal; then
     each timed in bf16 at its training N on its body, beside its FMA
     body, plain version, one dense PyTorch product and the bound
     (times-plan; qwen2-moe's ``experts.out`` at 0.875, C 8 and
     transposed G 8, keeps the FMA bodies for dX and dW);
 35. train-plan: full-width tinyllama under its plan (110 compact
     projections, wk/wv dense), 6 steps of 8 x 512 tokens as phase 6, and
     VGG19-CIFAR (9 sparse convs) and WRN-40-4 (23) under theirs, 6 steps
     at batch 256 as phase 30: every sparse launch counted at the launch
     and on the tensor cores, finite losses, ms/step, peak memory, card
     busy and idle share, beside phases 6 and 30;
 36. serve-plan: tinyllama under its plan through
     ``ContinuousEngine(plan=..., max_live_tokens=600)``, phase 4's 16
     requests: the admission budget equal to ``plan_aware_live_tokens``
     recomputed from ``model_matmul_shapes``, capped by the pool, the
     peak live tokens past 600 (the plan's credit admitted them), the
     bytes the storage holds beside the bytes credited, throughput and
     decode ms/step beside phase 4;
 37. parity-plan: its float32 greedy streams through the plan-aware
     engine against ``run_sequential`` on 4 requests, as phase 5.

The line before the last is the JSON ``{"kernels": [...]}`` record; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM data sheet's memory rate and dense bf16 tensor-core peak,
# from the one place the port keeps them (the plan compiler's cost model)
from repro_torch.kernels.perf_model import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.kernels.perf_model import PEAK_FLOPS as BF16_FLOPS  # noqa: E402

FULL_WIDTH = {"wq/wo": (2048, 2048), "wk/wv": (256, 2048),
              "gate/up": (5632, 2048), "down": (2048, 5632)}
# the seven projections of one decoder layer, by layout
LAYER_PROJECTIONS = {"wq/wo": 2, "wk/wv": 2, "gate/up": 2, "down": 1}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
L2_BYTES = 50 * 2**20
# token rows phase 2 holds rbgp4mm_rhs at: decode (1, 8, FMA body), the
# smallest mma launch (16), a half tile (64), a ragged tile edge (77,
# 1037) and prefill (512); phase_check_train adds a training step's 4096
CHECK_ROWS = (1, 8, 16, 64, 77, 512, 1037)
TRAIN_CHECK_ROWS = (16, 64, 77, 512, 1037, 4096)
# token rows of the body sweep (phase 3): decode, the sizes between it and
# the tensor-core bodies' threshold, and the serve prompts' prefill
BODY_SWEEP_ROWS = (8, 16, 32, 64, 128, 256, 512)
# qwen2-moe-a2.7b's routed experts: 60 of them, stacked over one layout a side
MOE_EXPERTS = 60
MOE_WIDTH = {"gate/up": (1408, 2048), "down": (2048, 1408)}
MOE_LAYER_PROJECTIONS = {"gate/up": 2, "down": 1}
# rows an expert: decode (8 slots, full capacity), a training step
# (ceil(4 * 512 * 4 / 60 * 1.25)), a full-capacity prefill of 512 tokens
MOE_ROWS = {"decode": 8, "train": 171, "prefill": 512}
# rows an expert the stacked forward and dX are checked at: decode, the
# least rows the tensor-core body takes, a ragged 128-token tile, training
# and prefill
MOE_CHECK_ROWS = (8, 16, 77, 171, 512)
# rows an expert the stacked tensor-core body's two token tiles are timed
# at: the least it takes, a tile edge that ties, whole tiles, a training
# step's 171 and another last tile under half full (300)
STACKED_TILE_ROWS = (16, 77, 128, 171, 256, 300, 512)
# chain dW token counts of the check phase at full width: decode-size,
# the least the tensor-core body takes, ragged stages and slices, prefill,
# a training step; the forward and dX there from 16 on (and at 1 and 8)
CHAIN_CHECK_ROWS = (8, 16, 77, 512, 1037, 4096)
# the serve phases' prompt lengths; the MoE engine prefills a request alone
# at full capacity, so these are also the stacked kernels' prefill rows
SERVE_PROMPT_LENS = (128, 256, 512)
# tinyllama-1.1b under the hierarchical-block plan of
# benchmarks/chain_executor.py: dense 4x4 outer blocking around three
# Ramanujan factors (their sparsities allocated by the designer) and a
# dense 8x8 leaf, at 0.875, on every projection of at least 256 a side
HIER = (("complete", 4, 4, 0.0), ("ramanujan", 0, 0, -1.0),
        ("ramanujan", 0, 0, -1.0), ("ramanujan", 0, 0, -1.0),
        ("complete", 8, 8, 0.0))
CHAIN_SPARSITY, CHAIN_MIN_DIM = 0.875, 256
# the smaller chains of tests/test_chain_executor.py: three Ramanujan
# factors with no complete leaf (G = C = 1), and a hierarchical chain
T3 = (("ramanujan", 0, 0, 0.5),) * 3
HIER_SMALL = (("complete", 4, 4, 0.0), ("ramanujan", 0, 0, 0.5),
              ("ramanujan", 0, 0, 0.5), ("ramanujan", 0, 0, 0.5),
              ("complete", 2, 2, 0.0))
SMALL_CHAINS = {"3ram": (128, 128, T3), "hier": (128, 256, HIER_SMALL)}
# the small RBGP4 layout of tests/test_torch_quant.py (G = 4, C = 8)
SMALL_RBGP4 = dict(g_o=(4, 4), g_r=(4, 8), g_i=(4, 2), g_b=(1, 1),
                   sp_o=0.5, sp_i=0.5, seed=3)
# the fifteen launch counters, by role; the last three are the int8
# (scales=) paths of rbgp4mm_rhs, rbgp4mm_rhs_stacked and chainmm_rhs
COUNTERS = ("forward", "dx", "dw", "stacked_forward", "stacked_dx",
            "stacked_dw", "chain_forward", "chain_dx", "chain_dw",
            "fm_forward", "fm_dx", "fm_dw", "forward_q", "stacked_forward_q",
            "chain_forward_q")
# VGG19-CIFAR's 15 sparsifiable convs at batch 256 as the paper's Table 1
# measures them (benchmarks/table1_models.py:36-57, the plan of
# src/repro/models/vision.py:123-124; the first conv and the classifier
# stay dense): (m, k, n) of O (m, n) = W_s (m, k) . I (k, n), with k =
# C_in * 3 * 3 and n = res^2 * 256
VGG19_SDMM = ((64, 576, 262144), (128, 576, 65536), (128, 1152, 65536),
              (256, 1152, 16384), (256, 2304, 16384), (256, 2304, 16384),
              (256, 2304, 16384), (512, 2304, 4096), (512, 4608, 4096),
              (512, 4608, 4096), (512, 4608, 4096), (512, 4608, 1024),
              (512, 4608, 1024), (512, 4608, 1024), (512, 4608, 1024))
# WideResNet-40-4's narrowest sparse conv (benchmarks/table1_models.py:
# 59-76), the one layout with C = 2
WRN_SDMM = (64, 144)
# WideResNet-40-4's 36 sparse convs (every conv but the stem and the three
# shortcut projections) at batch 256, (m, k, n) in network order as
# VGG19_SDMM: group g's first conv, then 11 more at its width
WRN40_4_CONV = (((64, 144, 262144),) + ((64, 576, 262144),) * 11
                + ((128, 576, 65536),) + ((128, 1152, 65536),) * 11
                + ((256, 1152, 16384),) + ((256, 2304, 16384),) * 11)
# the vision phases: the paper's sparsity, its batch, and its models' sparse
# convs (VGG19: every conv but the first; WRN-40-4: all but the stem and
# the projections, vision_plan's keep-dense rule)
VISION_SPARSITY = 0.75
VISION_BATCH = 256
VISION_ARCHS = ("vgg19-cifar", "wrn40-4-cifar")
VISION_PATTERNS = ("dense", "unstructured", "block", "rbgp4")
VISION_SPARSE = {"vgg19-cifar": 15, "wrn40-4-cifar": 36}
# the tensor-core launches (forward, dX, dW) a bf16 RBGP4 training step at
# batch 256 makes: rhs_path takes G in 16-128 and C % 8, sddmm_path C % 16,
# so 64 x 576 and 128 x 576 (C 8, transposed G 8) run dX and dW on the
# FMA bodies, and 64 x 144 (C 2, transposed G 2) all three
VISION_MMA = {"vgg19-cifar": (15, 13, 13), "wrn40-4-cifar": (35, 23, 23)}
# N of check-conv besides each layer's own: the least N of the tensor-core
# bodies, a ragged tile edge, a training step of the LM phases
CONV_CHECK_N = (16, 1037, 4096)
# N of check-fm: 1, the least N of the feature-major tensor-core bodies,
# ragged token tiles of them (1000, 4104), and 1037 (not a multiple of 8:
# the FMA bodies in bf16 too)
FM_CHECK_N = (1, 16, 1000, 1037, 4096, 4104)
# the paper's other Table 1 sparsities, checked in bf16 at the least N of
# the tensor-core bodies and at ragged token tiles of them
FM_CHECK_SPARSITIES = (0.5, 0.875, 0.9375)
FM_MMA_CHECK_N = (16, 1000, 4104)
# the plan phases (33-37): the budget plans the plan compiler solves for
# the four models at full width, solve_budget(model_matmul_shapes(cfg),
# target_density=0.25, min_dim=64), certified, checked, trained and served
PLAN_ARCHS = ("tinyllama-1.1b", "qwen2-moe-a2.7b", "vgg19-cifar",
              "wrn40-4-cifar")
PLAN_TARGET_DENSITY, PLAN_MIN_DIM = 0.25, 64
# check-plan's N: the least N of the tensor-core bodies, a ragged tile
# edge, a training step; rows an expert for the stacked pair: the least
# the tensor-core bodies take and a training step's
PLAN_CHECK_N = (16, 1037, 4096)
PLAN_EXPERT_ROWS = (16, MOE_ROWS["train"])
# serve-plan's admission budget B, in live tokens: one 576-token request
# (phase 4's longest) fits, two do not; what admits more is the plan's
# credit of freed weight bytes
PLAN_SERVE_BUDGET = 600


def vgg19_sdmm_layers() -> list:
    """The (m, k, n) of VGG19-CIFAR's 15 sparse layers, in network order."""
    return [tuple(s) for s in VGG19_SDMM]


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
             group_rows: int, elem_bytes: int, e: int = 1,
             int8: bool = False, n_out: int = 1) -> tuple[float, str]:
    """Least time for Y (n, m) = X (n, k) . W_s^T, for each of ``e``
    experts: every input read once (X, the compact W, the int32 column
    table the experts share), Y written once (and Z, ``n_out`` = 2, with
    ``save_preact``), against the data-sheet memory rate; the
    2*e*n*m*nnz_row operations the sparse products need against the bf16
    tensor-core peak.  The larger bounds it.  ``int8``: W is int8 leaf
    blocks (1 byte a value) with one f32 scale per (row group, chunk)."""
    n_blocks = (m // group_rows) * n_chunk_cols
    w_bytes = (m * nnz_row + 4 * n_blocks if int8
               else m * nnz_row * elem_bytes)
    nbytes = (e * ((n * k + n_out * n * m) * elem_bytes + w_bytes)
              + n_blocks * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * e * n * m * nnz_row / BF16_FLOPS
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
        for kernel, used, spills in ptxas_report(text):
            log("build", f"{name}: {kernel}: {used}; {spills}")
    name = torch.cuda.get_device_name(0)
    smi = card_line()
    print(smi, flush=True)
    log("build", f"card {name!r}; nvidia-smi name, power.limit: {smi}")
    return smi


def kernel_symbol(mangled: str) -> str:
    """``name<args>`` of the port's ``*_kernel`` symbol in a mangled name
    (its length prefix ends in a digit), the template arguments integers
    (``rbgp4mm_mma_kernel<16,128,4,2>``), bf16 or f32."""
    m = re.search(r"\d((?:rbgp4|chain)\w*?_kernel)"
                  r"(?:I((?:Li\d+E)+)|I(13__nv_bfloat16|f)E)?", mangled)
    if m is None:
        return ""
    arg = (",".join(re.findall(r"Li(\d+)E", m.group(2))) if m.group(2)
           else {"13__nv_bfloat16": "bf16", "f": "f32"}.get(m.group(3), ""))
    return m.group(1) + (f"<{arg}>" if arg else "")


def ptxas_report(text: str) -> list:
    """(kernel, registers and shared memory, stack and spills) for each
    entry function in nvcc's ``-Xptxas -v`` output, the kernel named by
    its symbol and template argument (``rbgp4mm_rhs_mma_kernel<128>``)."""
    out, kernel, spills = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line or "Function properties for" \
                in line:
            kernel = kernel_symbol(line) or line.strip()
        elif "spill" in line:
            spills = line.strip()
        elif "ptxas info" in line and "Used" in line and kernel:
            out.append((kernel, line.split(":", 1)[1].strip(), spills))
            spills = ""
    return out


def full_width_layouts():
    from repro_torch.core import RBGP4Layout, design_rbgp4

    return {key: RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
            for key, (m, k) in FULL_WIDTH.items()}


def agree(what: str, got, want, dt) -> tuple[float, float]:
    """(max|diff|, max|diff| / max|ref|); raises past the tolerance."""
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    if not (np.isfinite(err) and err <= TOL[dt] * scale):
        raise AssertionError(f"{what} {dt}: max|diff| {err} > {TOL[dt]} * "
                             f"max|ref| {scale}")
    return err, err / scale


def launched(counter, fn, attr: str = "launches"):
    """fn()'s result, checking that it launched its kernel exactly once
    (``counter.<attr>`` moved by one)."""
    before = getattr(counter, attr)
    out = fn()
    torch.cuda.synchronize()
    if getattr(counter, attr) != before + 1:
        raise AssertionError(f"launch counter {attr} did not move by one")
    return out


def phase_check(layouts) -> float:
    from repro_torch.kernels import (KernelTables, rbgp4mm_rhs,
                                     rbgp4mm_rhs_reference, rhs_path)

    g = torch.Generator(device="cuda").manual_seed(1)
    max_abs = 0.0
    n_cases = 0
    for key, lay in layouts.items():
        tables = KernelTables.build(lay, "cuda")
        for n in CHECK_ROWS:
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
                    y = launched(rbgp4mm_rhs, lambda: rbgp4mm_rhs(
                        tables, x, w, bias=b, act=act, residual=r))
                    want = rbgp4mm_rhs_reference(tables, x, w, bias=b,
                                                 act=act, residual=r)
                    err, rel = agree(f"{key} N={n} act={act}", y, want, dt)
                    worst = max(worst, rel)
                    max_abs = max(max_abs, err)
                    n_cases += 1
                log("check", f"{key:8s} N={n:<4d} {str(dt):15s} "
                             f"[{rhs_path(tables.dims, n, dt)} body] "
                             f"max|diff|/max|ref| = {worst:.2e} (3 epilogues)")
    log("check", f"{n_cases} cases agree; max abs diff {max_abs:.3e}")
    return max_abs


def phase_check_train(layouts) -> dict:
    """The training kernels against their plain versions: max abs diff per
    record entry ('rbgp4mm_rhs' with save_preact counts with the forward)."""
    from repro_torch.kernels import (KernelTables, TransposeTables,
                                     rbgp4_sddmm_rhs,
                                     rbgp4_sddmm_rhs_reference, rbgp4mm_rhs,
                                     rbgp4mm_rhs_reference, rhs_path,
                                     sddmm_path)

    g = torch.Generator(device="cuda").manual_seed(3)
    max_abs = {"forward": 0.0, "dx": 0.0, "dw": 0.0}
    n_cases = 0
    for key, lay in layouts.items():
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        dt_ = tt.tables.dims
        log("check", f"{key:8s} transposed layout {dt_.m} x {dt_.k}: G = "
                     f"{dt_.group_rows}, C = {dt_.chunk_cols}, "
                     f"{dt_.d_o * dt_.d_i} chunks a row")
        for dt in (torch.float32, torch.bfloat16):
            rnd = lambda *s: torch.randn(*s, device="cuda",
                                         generator=g).to(dt)
            worst = {"sddmm": 0.0, "save_preact": 0.0, "transposed": 0.0}
            # the body each launch took, by N
            bodies = {"sddmm": {}, "save_preact": {}, "transposed": {}}
            for n in (8,) + TRAIN_CHECK_ROWS:
                gy, x = rnd(n, lay.m), rnd(n, lay.k)
                dw = launched(rbgp4_sddmm_rhs,
                              lambda: rbgp4_sddmm_rhs(tables, gy, x))
                err, rel = agree(f"sddmm {key} N={n}", dw,
                                 rbgp4_sddmm_rhs_reference(tables, gy, x), dt)
                # no atomics, a fixed order of sums: a rerun, same bits
                if not torch.equal(dw, rbgp4_sddmm_rhs(tables, gy, x)):
                    raise AssertionError(f"sddmm {key} N={n} {dt}: a rerun "
                                         f"changed the bits")
                max_abs["dw"] = max(max_abs["dw"], err)
                worst["sddmm"] = max(worst["sddmm"], rel)
                bodies["sddmm"][n] = sddmm_path(tables.dims, n, dt)
                n_cases += 1
            w = rnd(*lay.data_shape)
            # the train path's forward and recompute run N = 4096
            for n in TRAIN_CHECK_ROWS:
                x = rnd(n, lay.k)
                for act, bias, res in ((None, False, False),
                                       ("silu", False, False),
                                       ("gelu", True, True)):
                    b = rnd(lay.m) if bias else None
                    r = rnd(n, lay.m) if res else None
                    y, z = launched(rbgp4mm_rhs, lambda: rbgp4mm_rhs(
                        tables, x, w, bias=b, act=act, residual=r,
                        save_preact=True))
                    wy, wz = rbgp4mm_rhs_reference(
                        tables, x, w, bias=b, act=act, residual=r,
                        save_preact=True)
                    for name, a, b_ in (("y", y, wy), ("z", z, wz)):
                        err, rel = agree(f"save_preact {key} N={n} "
                                         f"act={act} {name}", a, b_, dt)
                        max_abs["forward"] = max(max_abs["forward"], err)
                        worst["save_preact"] = max(worst["save_preact"], rel)
                    n_cases += 1
                bodies["save_preact"][n] = rhs_path(tables.dims, n, dt)
            wt = tt.values(w)
            for n in TRAIN_CHECK_ROWS:
                gy = rnd(n, lay.m)
                dx = launched(rbgp4mm_rhs,
                              lambda: rbgp4mm_rhs(tt.tables, gy, wt),
                              "launches_dx")
                err, rel = agree(f"transposed {key} N={n}", dx,
                                 rbgp4mm_rhs_reference(tt.tables, gy, wt), dt)
                max_abs["dx"] = max(max_abs["dx"], err)
                worst["transposed"] = max(worst["transposed"], rel)
                bodies["transposed"][n] = rhs_path(dt_, n, dt)
                n_cases += 1
            log("check", f"{key:8s} {str(dt):15s} max|diff|/max|ref|: "
                         + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                         + "; bodies: " + "; ".join(
                             f"{k} " + ", ".join(f"N={n} {b}"
                                                 for n, b in v.items())
                             for k, v in bodies.items()))
        torch.cuda.empty_cache()
    log("check", f"{n_cases} training-kernel cases agree, every dW "
                 f"bit-equal on a rerun; max abs diff "
                 + ", ".join(f"{k} {v:.3e}" for k, v in max_abs.items()))
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


def sddmm_bound_ms(n: int, m: int, k: int, nnz_row: int, n_chunk_cols: int,
                   group_rows: int, elem_bytes: int,
                   e: int = 1) -> tuple[float, str]:
    """Least time for compact dW (m, nnz_row) = pack(g (n, m)^T . x (n, k)),
    for each of ``e`` experts: g, x and the column table read once, dW
    written once; 2*e*n*m*nnz_row operations against the bf16 tensor-core
    peak."""
    nbytes = (e * (n * m + n * k + m * nnz_row) * elem_bytes
              + (m // group_rows) * n_chunk_cols * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * e * n * m * nnz_row / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def body_launchers(tables, path: str):
    """Launchers of body ``path`` ("fma" or "mma") of ``rbgp4mm_rhs`` and
    ``rbgp4_sddmm_rhs`` on given operands and outputs, whatever
    ``rhs_path``/``sddmm_path`` would choose: the wrappers' own C launch
    (``_rhs_body``, ``_sddmm_body`` of kernels/rbgp4mm.py), the yardstick
    of one body against the other.  Their launches are comparisons and
    move no counter."""
    from repro_torch.kernels.rbgp4mm import _rhs_body, _sddmm_body

    def rhs(x, w, out, z=None, act=None, bias=None):
        _rhs_body(path, tables, x, w, out, z, act=act, bias=bias)

    def sddmm(g, x, dw):
        _sddmm_body(path, tables, g, x, dw)

    return rhs, sddmm


def stacked_body_launcher(tables, path: str, block_tokens: int = None):
    """``body_launchers``' twin for ``rbgp4mm_rhs_stacked``: body ``path``
    on stacked operands (the mma body with ``block_tokens`` tokens a
    block, the wrapper's own choice unless given), through the wrapper's
    own C launch (``_rhs_stacked_body``); no counter moves."""
    from repro_torch.kernels.rbgp4mm import _rhs_stacked_body

    def rhs(x, w, out, z=None, act=None, bias=None):
        _rhs_stacked_body(path, tables, x, w, out, z, act=act, bias=bias,
                          block_tokens=block_tokens)

    return rhs


def stacked_sddmm_launcher(tables, path: str, plan=None):
    """``body_launchers``' twin for ``rbgp4_sddmm_rhs_stacked``: body
    ``path`` on stacked operands (the mma body with ``plan``,
    ``stacked_sddmm_mma_plan``'s unless given), through the wrapper's own
    C launch (``_sddmm_stacked_body``); no counter moves."""
    from repro_torch.kernels.rbgp4mm import _sddmm_stacked_body

    def sddmm(g, x, dw):
        _sddmm_stacked_body(path, tables, g, x, dw, plan=plan)

    return sddmm


def chain_body_launchers(tables, path: str):
    """``body_launchers``' twin for ``chainmm_rhs`` and
    ``chain_sddmm_rhs``: body ``path`` on given operands, through the
    wrappers' own C launch (``_chain_rhs_body``, ``_chain_sddmm_body`` of
    kernels/chainmm.py); no counter moves."""
    from repro_torch.kernels.chainmm import _chain_rhs_body, _chain_sddmm_body

    def rhs(x, w, out):
        _chain_rhs_body(path, tables, x, w, out)

    def sddmm(g, x, dw):
        _chain_sddmm_body(path, tables, g, x, dw)

    return rhs, sddmm


def phase_train_times(layouts, n: int = 4096) -> dict:
    """The training calls at a training step's N tokens, bf16: the forward
    with ``save_preact`` (and silu, the call of a fused projection and of
    its remat recompute), dW (rbgp4_sddmm_rhs) and dX (rbgp4mm_rhs on the
    transposed layout): kernel, its FMA body on the same operands
    (``fma_ms``), plain version, the dense cuBLAS product (``F.linear`` on
    W unpacked, g^T @ x, g @ W), bound."""
    from repro_torch.kernels import (KernelTables, TransposeTables,
                                     rbgp4_sddmm_rhs,
                                     rbgp4_sddmm_rhs_reference, rbgp4mm_rhs,
                                     rbgp4mm_rhs_reference, rhs_path,
                                     sddmm_path)
    from repro_torch.kernels.ref import unpack_dense

    g = torch.Generator(device="cuda").manual_seed(4)
    dt = torch.bfloat16
    rows = {}
    for key, lay in layouts.items():
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        dims, dims_t = tables.dims, tt.tables.dims
        m, k = lay.m, lay.k
        nnz = lay.data_shape[1]
        copies = max(2, -(-2 * L2_BYTES // ((n * m + n * k) * 2)))
        gs = torch.randn((copies, n, m), device="cuda", generator=g).to(dt)
        xs = torch.randn((copies, n, k), device="cuda", generator=g).to(dt)
        w = torch.randn((m, nnz), device="cuda", generator=g).to(dt)
        wt = tt.values(w)
        wd = unpack_dense(lay, w)
        c = lambda i: i % copies
        fma_rhs, fma_sddmm = body_launchers(tables, "fma")
        fma_rhs_t, _ = body_launchers(tt.tables, "fma")
        y_out, z_out = (torch.empty((n, m), dtype=dt, device="cuda")
                        for _ in range(2))
        dx_out = torch.empty((n, k), dtype=dt, device="cuda")
        dw_out = torch.empty((m, nnz), dtype=dt, device="cuda")
        t = dict(
            fwd_fma=time_cuda(lambda i: fma_rhs(xs[c(i)], w, y_out, z_out,
                                                "silu")),
            dw_fma=time_cuda(lambda i: fma_sddmm(gs[c(i)], xs[c(i)],
                                                 dw_out)),
            dx_fma=time_cuda(lambda i: fma_rhs_t(gs[c(i)], wt, dx_out)),
            fwd=time_cuda(lambda i: rbgp4mm_rhs(tables, xs[c(i)], w,
                                                act="silu",
                                                save_preact=True)),
            fwd_plain=time_cuda(lambda i: rbgp4mm_rhs_reference(
                tables, xs[c(i)], w, act="silu", save_preact=True)),
            fwd_lib=time_cuda(lambda i: F.linear(xs[c(i)], wd)),
            dw=time_cuda(lambda i: rbgp4_sddmm_rhs(tables, gs[c(i)],
                                                   xs[c(i)])),
            dw_plain=time_cuda(lambda i: rbgp4_sddmm_rhs_reference(
                tables, gs[c(i)], xs[c(i)])),
            dw_lib=time_cuda(lambda i: gs[c(i)].T @ xs[c(i)]),
            dx=time_cuda(lambda i: rbgp4mm_rhs(tt.tables, gs[c(i)], wt)),
            dx_plain=time_cuda(lambda i: rbgp4mm_rhs_reference(
                tt.tables, gs[c(i)], wt)),
            dx_lib=time_cuda(lambda i: gs[c(i)] @ wd),
        )
        b, by = bound_ms(n, m, k, nnz, dims.d_o * dims.d_i,
                         dims.group_rows, 2, n_out=2)
        rows[(key, "fwd")] = dict(ms=t["fwd"], plain_ms=t["fwd_plain"],
                                  library_ms=t["fwd_lib"], bound_ms=b,
                                  bound_by=by, fma_ms=t["fwd_fma"])
        log("times", f"forward {key:8s} N={n} bf16, save_preact, silu "
                     f"[{rhs_path(dims, n, dt)} body]: kernel "
                     f"{t['fwd']:.4f} ms, FMA body {t['fwd_fma']:.4f} ms, "
                     f"plain {t['fwd_plain']:.4f} ms, "
                     f"F.linear dense {t['fwd_lib']:.4f} ms, bound "
                     f"{b * 1e3:.2f} us ({by})")
        b, by = sddmm_bound_ms(n, m, k, nnz, dims.d_o * dims.d_i,
                               dims.group_rows, 2)
        rows[(key, "dw")] = dict(ms=t["dw"], plain_ms=t["dw_plain"],
                                 library_ms=t["dw_lib"], bound_ms=b,
                                 bound_by=by, fma_ms=t["dw_fma"])
        log("times", f"dW {key:8s} N={n} bf16 [{sddmm_path(dims, n, dt)} "
                     f"body]: kernel {t['dw']:.4f} ms, FMA body "
                     f"{t['dw_fma']:.4f} ms, plain "
                     f"{t['dw_plain']:.4f} ms, g^T @ x dense "
                     f"{t['dw_lib']:.4f} ms, bound {b * 1e3:.2f} us ({by})")
        b, by = bound_ms(n, dims_t.m, dims_t.k, dims_t.data_cols,
                         dims_t.d_o * dims_t.d_i, dims_t.group_rows, 2)
        rows[(key, "dx")] = dict(ms=t["dx"], plain_ms=t["dx_plain"],
                                 library_ms=t["dx_lib"], bound_ms=b,
                                 bound_by=by, fma_ms=t["dx_fma"])
        log("times", f"dX {key:8s} N={n} bf16 (G = {dims_t.group_rows}, "
                     f"C = {dims_t.chunk_cols}) [{rhs_path(dims_t, n, dt)} "
                     f"body]: kernel {t['dx']:.4f} ms, FMA body "
                     f"{t['dx_fma']:.4f} ms, "
                     f"plain {t['dx_plain']:.4f} ms, g @ W dense "
                     f"{t['dx_lib']:.4f} ms, bound {b * 1e3:.2f} us ({by})")
        del gs, xs, w, wt, wd, y_out, z_out, dx_out, dw_out
        torch.cuda.empty_cache()
    return rows


def phase_body_sweep(layouts, ns=BODY_SWEEP_ROWS) -> dict:
    """Both bodies of ``rbgp4mm_rhs`` (the forward as a prefill calls it,
    no epilogue; dX on the transposed layout) and ``rbgp4_sddmm_rhs`` at
    tinyllama's four layouts from decode to the serve prompts' prefill,
    bf16, on the same operands: each body's result first held against the
    plain version, then both timed (CUDA events, operands cycled past the
    L2).  Returns {(kind, n): {"mma": ms, "fma": ms}}, kind "fwd", "dx" or
    "dw", summed over one decoder layer's seven projections: the
    measurement ``MMA_MIN_TOKENS`` is set from."""
    from repro_torch.kernels import (MMA_MIN_TOKENS, KernelTables,
                                     TransposeTables,
                                     rbgp4_sddmm_rhs_reference,
                                     rbgp4mm_rhs_reference)

    g = torch.Generator(device="cuda").manual_seed(5)
    dt = torch.bfloat16
    paths = ("mma", "fma")
    layer = {(kind, n): {p: 0.0 for p in paths}
             for kind in ("fwd", "dx", "dw") for n in ns}
    for key, lay in layouts.items():
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        m, k = lay.m, lay.k
        launch = {p: (body_launchers(tables, p), body_launchers(tt.tables, p))
                  for p in paths}
        count = LAYER_PROJECTIONS[key]
        for n in ns:
            copies = max(2, -(-2 * L2_BYTES
                              // ((m * lay.data_shape[1] + n * (m + k)) * 2)))
            rnd = lambda *s: torch.randn(*s, device="cuda",
                                         generator=g).to(dt)
            ws, xs, gs = (rnd(copies, *lay.data_shape), rnd(copies, n, k),
                          rnd(copies, n, m))
            wts = torch.stack([tt.values(ws[i]) for i in range(copies)])
            c = lambda i: i % copies
            outs = {"fwd": torch.empty((n, m), dtype=dt, device="cuda"),
                    "dx": torch.empty((n, k), dtype=dt, device="cuda"),
                    "dw": torch.empty(lay.data_shape, dtype=dt,
                                      device="cuda")}
            calls = {
                "fwd": (lambda p, i: launch[p][0][0](xs[c(i)], ws[c(i)],
                                                     outs["fwd"]),
                        lambda: rbgp4mm_rhs_reference(tables, xs[0],
                                                      ws[0])),
                "dx": (lambda p, i: launch[p][1][0](gs[c(i)], wts[c(i)],
                                                    outs["dx"]),
                       lambda: rbgp4mm_rhs_reference(tt.tables, gs[0],
                                                     wts[0])),
                "dw": (lambda p, i: launch[p][0][1](gs[c(i)], xs[c(i)],
                                                    outs["dw"]),
                       lambda: rbgp4_sddmm_rhs_reference(tables, gs[0],
                                                         xs[0])),
            }
            line = []
            for kind, (run, ref) in calls.items():
                want = ref()
                ms = {}
                for p in paths:
                    run(p, 0)
                    torch.cuda.synchronize()
                    agree(f"sweep {kind} {key} N={n} [{p} body]",
                          outs[kind], want, dt)
                    ms[p] = time_cuda(lambda i: run(p, i))
                    layer[(kind, n)][p] += count * ms[p]
                line.append(f"{kind} mma {ms['mma']:.4f} / fma "
                            f"{ms['fma']:.4f}")
            log("times", f"bodies {key:8s} N={n:<4d} bf16: "
                         + ", ".join(line) + " ms")
            del ws, xs, gs, wts, outs
        torch.cuda.empty_cache()
    for n in ns:
        log("times", f"bodies per tinyllama layer N={n:<4d}: " + ", ".join(
            f"{kind} mma {layer[(kind, n)]['mma']:.4f} / fma "
            f"{layer[(kind, n)]['fma']:.4f} ms"
            for kind in ("fwd", "dx", "dw")))
    for kind in ("fwd", "dx", "dw"):
        # the least swept N from which the mma body is the faster at
        # every larger swept N (None: the FMA body wins at 512 too)
        faster = [layer[(kind, n)]["mma"] < layer[(kind, n)]["fma"]
                  for n in ns]
        cross = next((n for i, n in enumerate(ns) if all(faster[i:])), None)
        log("times", f"bodies {kind}: the tensor-core body is the faster "
                     f"from N = {cross} on (swept {ns}); the wrappers take "
                     f"it from N = {MMA_MIN_TOKENS}")
    return layer


def main_config(compute_dtype: str = "bfloat16",
                arch: str = "tinyllama-1.1b"):
    from repro_torch.configs import apply_sparsity, get_config

    cfg = apply_sparsity(get_config(arch), pattern="rbgp4", sparsity=0.75,
                         min_dim=64)
    return cfg.with_(compute_dtype=compute_dtype)


def moe_config(compute_dtype: str = "bfloat16"):
    return main_config(compute_dtype, "qwen2-moe-a2.7b")


def launches_of(**kw) -> dict:
    """A full launch-count dict: the given counters, every other one 0."""
    return {k: kw.get(k, 0) for k in COUNTERS}


def launch_counts() -> dict:
    """The fifteen launch counters, by role."""
    from repro_torch.kernels import (chain_sddmm_rhs, chainmm_rhs,
                                     rbgp4_sddmm, rbgp4_sddmm_rhs,
                                     rbgp4_sddmm_rhs_stacked, rbgp4mm,
                                     rbgp4mm_rhs, rbgp4mm_rhs_stacked)

    return {"forward": rbgp4mm_rhs.launches,
            "forward_q": rbgp4mm_rhs.launches_q,
            "stacked_forward_q": rbgp4mm_rhs_stacked.launches_q,
            "chain_forward_q": chainmm_rhs.launches_q,
            "dx": rbgp4mm_rhs.launches_dx,
            "dw": rbgp4_sddmm_rhs.launches,
            "stacked_forward": rbgp4mm_rhs_stacked.launches,
            "stacked_dx": rbgp4mm_rhs_stacked.launches_dx,
            "stacked_dw": rbgp4_sddmm_rhs_stacked.launches,
            "chain_forward": chainmm_rhs.launches,
            "chain_dx": chainmm_rhs.launches_dx,
            "chain_dw": chain_sddmm_rhs.launches,
            "fm_forward": rbgp4mm.launches,
            "fm_dx": rbgp4mm.launches_dx,
            "fm_dw": rbgp4_sddmm.launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels import (chain_sddmm_rhs, chainmm_rhs,
                                     rbgp4_sddmm, rbgp4_sddmm_rhs,
                                     rbgp4_sddmm_rhs_stacked, rbgp4mm,
                                     rbgp4mm_rhs, rbgp4mm_rhs_stacked)

    rbgp4mm_rhs.launches = rbgp4mm_rhs.launches_dx = 0
    rbgp4mm_rhs.launches_mma = rbgp4_sddmm_rhs.launches_mma = 0
    rbgp4mm_rhs_stacked.launches_mma = chain_sddmm_rhs.launches_mma = 0
    rbgp4_sddmm_rhs_stacked.launches_mma = chainmm_rhs.launches_mma = 0
    rbgp4mm_rhs.launches_q = rbgp4mm_rhs_stacked.launches_q = 0
    chainmm_rhs.launches_q = 0
    rbgp4_sddmm_rhs.launches = 0
    rbgp4mm_rhs_stacked.launches = rbgp4mm_rhs_stacked.launches_dx = 0
    rbgp4_sddmm_rhs_stacked.launches = 0
    chainmm_rhs.launches = chainmm_rhs.launches_dx = 0
    chain_sddmm_rhs.launches = 0
    rbgp4mm.launches = rbgp4mm.launches_dx = rbgp4mm.launches_mma = 0
    rbgp4_sddmm.launches = rbgp4_sddmm.launches_mma = 0


def body_counts() -> dict:
    """The launches that took the bf16 tensor-core bodies, by the role
    whose counter they also moved: ``rbgp4mm_rhs``,
    ``rbgp4mm_rhs_stacked`` and ``chainmm_rhs`` (forward and dX, keyed by
    the forward role), ``rbgp4_sddmm_rhs``, ``rbgp4_sddmm_rhs_stacked``
    and ``chain_sddmm_rhs``."""
    from repro_torch.kernels import (chain_sddmm_rhs, chainmm_rhs,
                                     rbgp4_sddmm_rhs,
                                     rbgp4_sddmm_rhs_stacked, rbgp4mm_rhs,
                                     rbgp4mm_rhs_stacked)

    return {"forward": rbgp4mm_rhs.launches_mma,
            "dw": rbgp4_sddmm_rhs.launches_mma,
            "stacked_forward": rbgp4mm_rhs_stacked.launches_mma,
            "stacked_dw": rbgp4_sddmm_rhs_stacked.launches_mma,
            "chain_forward": chainmm_rhs.launches_mma,
            "chain_dw": chain_sddmm_rhs.launches_mma}


def train_mma_counts(launches: dict) -> dict:
    """The tensor-core launches a training step's ``launches`` (by role)
    must show: every bf16 launch of a step (16 rows an expert and more)
    runs enough tokens on layouts those bodies take, so every one."""
    return {"forward": launches["forward"] + launches["dx"],
            "dw": launches["dw"],
            "stacked_forward": (launches["stacked_forward"]
                                + launches["stacked_dx"]),
            "stacked_dw": launches["stacked_dw"],
            "chain_forward": launches["chain_forward"] + launches["chain_dx"],
            "chain_dw": launches["chain_dw"]}


def counts_since(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in COUNTERS}


def count_calls(model, name: str, per_call: list) -> None:
    """Wrap ``model.<name>`` so that each call appends its own launch
    counts to ``per_call``."""
    fn = getattr(model, name)

    def counted(*args, **kw):
        before = launch_counts()
        out = fn(*args, **kw)
        per_call.append(counts_since(before))
        return out

    setattr(model, name, counted)


def free_card() -> None:
    """Free what the phase left on the card.  The phases wrap model
    methods to count calls, which ties each model into a reference cycle
    that only the collector breaks; without it the next phase's peak
    memory would include the last phase's model."""
    gc.collect()
    torch.cuda.empty_cache()


def serve_requests(vocab: int, n: int, seed: int) -> list:
    from repro_torch.data import RequestStream

    return RequestStream(vocab, n, prompt_lens=SERVE_PROMPT_LENS,
                         gen_lens=(8, 16, 32, 64), seed=seed).requests()


def quant_config(cfg):
    """``cfg`` with its plan's compact and chain rules stamped
    ``quant='int8'``, as ``launch/serve.py --quant int8`` stamps it."""
    from repro_torch.configs import apply_sparsity

    return apply_sparsity(cfg, plan=cfg.sparsity_rules.with_quant("int8"))


def build_model(cfg, quant: bool):
    """The model of ``cfg`` on the card, seed 0; with ``quant`` (a
    ``quant_config``), its compact and chain projections quantized to int8
    leaf blocks, as ``launch/serve.py --quant int8`` does."""
    from repro_torch.models import LMModel
    from repro_torch.sparsity import quantize_weights

    model = LMModel(cfg, device="cuda", seed=0)
    if quant:
        quantize_weights(model)
    return model


def phase_serve(cfg, per_pass: dict, phase: str = "serve",
                quant: bool = False, beside: dict = None,
                engine_kw: dict = None) -> dict:
    """16 mixed requests through ``ContinuousEngine`` (bf16, f32 KV cache,
    8 slots, 16-token pages, greedy); every prefill call and every decode
    step must launch ``per_pass``.  ``quant``: the weight-only int8 model
    of ``cfg`` (a ``quant_config``); ``beside``: the result of the
    full-precision run of the same model, printed beside this one;
    ``engine_kw``: more arguments of the engine (``plan`` and
    ``max_live_tokens``: plan-aware admission), whose budget, pool and
    peak live tokens and requests the result then carries."""
    from repro_torch.serve import ContinuousEngine
    from repro_torch.sparsity import weight_bytes

    t0 = time.perf_counter()
    model = build_model(cfg, quant)
    torch.cuda.synchronize()
    n_compact = sum(1 for mod in model.modules()
                    if getattr(mod, "mode", None) == "compact")
    n_stacked = sum(1 for mod in model.modules()
                    if getattr(mod, "compact", False)) * 3
    n_chain = sum(1 for mod in model.modules()
                  if getattr(mod, "mode", None) == "chain")
    n_quant = sum(1 for mod in model.modules()
                  if getattr(mod, "quantized", False))
    want = tuple(per_pass[k] + per_pass[k + "_q"]
                 for k in ("forward", "stacked_forward", "chain_forward"))
    if (n_compact, n_stacked, n_chain) != want:
        raise AssertionError(f"{n_compact} compact projections, "
                             f"{n_stacked} stacked ones and {n_chain} "
                             f"chains, want {per_pass}")
    wb = weight_bytes(model)
    log(phase, f"{cfg.name}: {cfg.n_layers} layers, d_model "
               f"{cfg.d_model}, {model.n_params():,} stored values "
               f"({n_compact} compact rbgp4 projections, {n_stacked} "
               f"stacked expert projections, {n_chain} chain projections; "
               f"{n_quant} modules in int8 storage), built in "
               f"{time.perf_counter() - t0:.1f}s; stored bytes: sparse "
               f"values {wb['values']:,}, scales {wb['scales']:,}, the "
               f"rest {wb['other']:,}")
    reqs = serve_requests(cfg.vocab_size, 16, seed=0)
    max_len = max(r["prompt"].shape[0] + r["max_new_tokens"] for r in reqs)
    kw = dict(page_size=16, max_slots=8, max_request_len=max_len,
              cache_dtype=torch.float32)
    # warm-up (cuBLAS handles, allocator), not counted
    warm = ContinuousEngine(model, **kw)
    warm.submit(reqs[0]["prompt"][:32], 2)
    warm.drain()
    del warm
    engine = ContinuousEngine(model, **kw, **(engine_kw or {}))
    peak = {"live_tokens": 0, "running": 0}
    admit = engine.scheduler.admit

    def admit_and_track():
        got = admit()
        peak["live_tokens"] = max(peak["live_tokens"],
                                  engine.scheduler.live_tokens)
        peak["running"] = max(peak["running"], len(engine.scheduler.running))
        return got

    engine.scheduler.admit = admit_and_track
    per_call = {"prefill": [], "decode": []}
    count_calls(model, "prefill", per_call["prefill"])
    count_calls(model, "decode_step_paged", per_call["decode"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r["prompt"], r["max_new_tokens"])
    out = engine.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    mma = body_counts()
    st = engine.stats
    for r in reqs:
        toks = np.asarray(out[r["rid"]])
        if toks.shape != (r["max_new_tokens"],):
            raise AssertionError(f"request {r['rid']}: {toks.shape} tokens, "
                                 f"want {r['max_new_tokens']}")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r['rid']}: token out of range")
    passes = st["prefill_calls"] + st["decode_steps"]
    if (len(per_call["prefill"]), len(per_call["decode"])) != (
            st["prefill_calls"], st["decode_steps"]):
        raise AssertionError(f"{len(per_call['prefill'])} prefill and "
                             f"{len(per_call['decode'])} decode calls "
                             f"counted, engine stats {st}")
    for kind, calls in per_call.items():
        for i, c in enumerate(calls):
            if c != per_pass:
                raise AssertionError(f"{kind} call {i}: launches {c}, "
                                     f"want {per_pass}")
    if counts != {k: v * passes for k, v in per_pass.items()} \
            or passes == 0:
        raise AssertionError(f"launches {counts} for {passes} passes; "
                             f"want {per_pass} per pass")
    # a full-capacity prefill puts every prompt token (128 and more) in
    # every expert: its bf16 stacked launches take the tensor-core body;
    # a decode step's 8 rows an expert keep the FMA body
    want_s = 0 if quant else st["prefill_calls"] * per_pass["stacked_forward"]
    if mma["stacked_forward"] != want_s:
        raise AssertionError(f"{mma['stacked_forward']} stacked launches on "
                             f"the tensor cores, want {want_s} (every "
                             f"prefill's, no decode step's)")
    # a prefill's bf16 chain launches (every prompt token, 128 and more)
    # take the tensor-core body too, a decode step's 8 rows the FMA body
    want_c = 0 if quant else st["prefill_calls"] * per_pass["chain_forward"]
    if mma["chain_forward"] != want_c:
        raise AssertionError(f"{mma['chain_forward']} chain launches on the "
                             f"tensor cores, want {want_c} (every "
                             f"prefill's, no decode step's)")
    n_prompt, n_gen = st["prompt_tokens"], st["generated_tokens"]
    res = dict(
        requests=len(out), prompt_tokens=n_prompt, generated_tokens=n_gen,
        wall_s=wall, tok_per_s=(n_prompt + n_gen) / wall,
        prefill_calls=st["prefill_calls"], decode_steps=st["decode_steps"],
        prefill_time_s=st["prefill_time_s"],
        decode_time_s=st["decode_time_s"],
        decode_ms_per_step=1e3 * st["decode_time_s"] / st["decode_steps"],
        decode_tok_per_s=n_gen / st["decode_time_s"],
        peak_allocated_blocks=st["peak_allocated_blocks"],
        launches=counts, launches_per_pass=per_pass, mma_launches=mma,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        weight_bytes=wb,
        plan_fingerprint=cfg.sparsity_rules.fingerprint(),
        peak_live_tokens=peak["live_tokens"],
        peak_live_requests=peak["running"],
        base_live_tokens=engine.base_live_tokens,
        plan_live_tokens=engine.plan_live_tokens,
        admission_tokens=engine.scheduler.max_live_tokens,
        pool_tokens=engine.kv.allocator.n_total * engine.page,
        kv_bytes_per_token=engine.kv_bytes_per_token(),
        projection_bytes=projection_bytes(model),
    )
    log(phase, f"served {len(out)} requests: {n_prompt} prompt + {n_gen} "
               f"new tokens in {wall:.3f}s = {res['tok_per_s']:.1f} tok/s")
    log(phase, f"prefill {st['prefill_calls']} calls in "
               f"{st['prefill_time_s']:.3f}s; decode {st['decode_steps']} "
               f"steps in {st['decode_time_s']:.3f}s "
               f"({res['decode_tok_per_s']:.1f} tok/s, "
               f"{res['decode_ms_per_step']:.2f} ms/step)")
    log(phase, f"launches per prefill call and per decode step, counted at "
               f"each launch: "
               + ", ".join(f"{k} {v}" for k, v in per_pass.items() if v)
               + f"; in all {counts} over {passes} passes; peak "
                 f"{st['peak_allocated_blocks']} blocks; peak memory "
                 f"{res['peak_mem_gb']:.2f} GB")
    if beside is not None:
        log(phase, "int8 against full precision (the same requests): "
                   + ", ".join(
                       f"{k} {res[k]:.4g} vs {beside[k]:.4g}"
                       for k in ("tok_per_s", "decode_ms_per_step",
                                 "prefill_time_s", "peak_mem_gb"))
                   + f", sparse value + scale bytes "
                     f"{wb['values'] + wb['scales']:,} vs "
                     f"{beside['weight_bytes']['values']:,}")
    print(f"{phase} " + json.dumps(res), flush=True)
    del model, engine
    free_card()
    return res


def serve_streams(model, reqs: list,
                  engine_kw: dict = None) -> tuple[dict, int]:
    """The engine's greedy streams (f32 KV cache, 8 slots, 16-token
    pages; ``engine_kw`` more engine arguments) and its gather length."""
    from repro_torch.serve import ContinuousEngine

    max_len = max(r["prompt"].shape[0] + r["max_new_tokens"] for r in reqs)
    engine = ContinuousEngine(model, page_size=16, max_slots=8,
                              max_request_len=max_len,
                              cache_dtype=torch.float32,
                              **(engine_kw or {}))
    for r in reqs:
        engine.submit(r["prompt"], r["max_new_tokens"])
    return engine.drain(), engine.gather_tokens


def phase_parity(cfg, reqs: list, phase: str = "parity",
                 quant: bool = False, engine_kw: dict = None) -> None:
    """float32: the engine's greedy streams against ``run_sequential``; a
    flip is tolerated only at a near tie of the top-2 logits.  ``quant``:
    the weight-only int8 model of ``cfg`` (a ``quant_config``), whose
    streams must also equal the engine's after ``dequantize_weights``;
    ``engine_kw``: more engine arguments (plan-aware admission)."""
    from repro_torch.serve import run_sequential
    from repro_torch.sparsity import dequantize_weights

    model = build_model(cfg, quant)
    t0 = time.perf_counter()
    got, gather = serve_streams(model, reqs, engine_kw)
    want = run_sequential(model, reqs, cache_len=gather)
    flips = same_streams(model, reqs, got, want, phase, "run_sequential")
    what = "run_sequential"
    if quant:
        dequantize_weights(model)
        deq, _ = serve_streams(model, reqs)
        flips += same_streams(model, reqs, got, deq, phase,
                              "the dequantized model's engine")
        what += " and the dequantized model's engine"
    n_tok = sum(len(v) for v in got.values())
    log(phase, f"{cfg.name} ({cfg.n_layers} layers) float32 engine vs "
               f"{what}: {len(reqs)} requests, {n_tok} tokens, {flips} "
               f"near-tie flips ({time.perf_counter() - t0:.1f}s)")
    del model
    free_card()


def same_streams(model, reqs: list, got: dict, want: dict, phase: str,
                 what: str) -> int:
    """Raises unless the streams are equal, a flip tolerated only at a
    near tie of the top-2 logits; returns the number of such flips."""
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
            log(phase, f"request {r['rid']}: near-tie flip at token {t} "
                       f"(top-2 gap {gap:.3e} < 1e-4 x {scale:.3e})")
            continue
        raise AssertionError(
            f"request {r['rid']}: engine and {what} differ at token "
            f"{t} ({a[t]} vs {b[t]}; top-2 gap {gap:.3e}, max|logit| "
            f"{scale:.3e})")
    return flips


# kernel symbol (the trace names the kernel, not its role) -> its role,
# for a forward kernel the role it has right after its family's dW kernel
# (dX), and its body: "fma", "mma" (the bf16 tensor-core bodies, counted
# apart by ``body_counts``) or "sum" (a dW mma body's slice sum, a second
# kernel of a counted launch: its time goes to dW, it counts as no
# launch); the stacked names first
TRACE_KINDS = (
    ("chain_sddmm_rhs_mma_kernel", "chain_dw", None, "mma"),
    ("chain_sddmm_rhs_sum_kernel", "chain_dw", None, "sum"),
    ("chain_sddmm_rhs_kernel", "chain_dw", None, "fma"),
    ("chainmm_rhs_mma_kernel", "chain_forward", "chain_dx", "mma"),
    ("chainmm_rhs_kernel", "chain_forward", "chain_dx", "fma"),
    ("rbgp4_sddmm_rhs_stacked_mma_kernel", "stacked_dw", None, "mma"),
    ("rbgp4_sddmm_rhs_stacked_sum_kernel", "stacked_dw", None, "sum"),
    ("rbgp4_sddmm_rhs_stacked_kernel", "stacked_dw", None, "fma"),
    ("rbgp4mm_rhs_stacked_mma_kernel", "stacked_forward", "stacked_dx",
     "mma"),
    ("rbgp4mm_rhs_stacked_kernel", "stacked_forward", "stacked_dx", "fma"),
    ("rbgp4_sddmm_rhs_mma_kernel", "dw", None, "mma"),
    ("rbgp4_sddmm_rhs_sum_kernel", "dw", None, "sum"),
    ("rbgp4_sddmm_rhs_kernel", "dw", None, "fma"),
    ("rbgp4mm_rhs_mma_kernel", "forward", "dx", "mma"),
    ("rbgp4mm_rhs_kernel", "forward", "dx", "fma"),
)


# profiled steps to try before a trace that keeps losing kernel records
# fails the phase, and the spin kernels (``torch.cuda._sleep``, symbol
# ``spin_kernel``) launched ahead of the step in each profiled window
PROFILE_TRIES = 3
PROFILE_PAD = 2000


def split_trace(kernels: list) -> tuple[dict, dict, dict]:
    """The trace's sparse launches by role and their card time, and the
    launches by kernel symbol.  The trace names the kernel, not its role:
    an ``rbgp4mm_rhs`` launch (either body) is taken as a dX when the last
    sparse kernel before it was ``rbgp4_sddmm_rhs`` (either body, or its
    slice sum: the backward of every projection runs dW, then dX),
    otherwise as a forward or its recompute, and the same for the stacked
    and the chain pairs.  A slice sum adds its time to dW and counts as
    no launch."""
    ms = dict.fromkeys(COUNTERS, 0.0)
    count = dict.fromkeys(COUNTERS, 0)
    by_symbol = {symbol: 0 for symbol, _, _, _ in TRACE_KINDS}
    last = None
    for _, dur, name in kernels:
        for symbol, role, dx_role, body in TRACE_KINDS:
            if symbol in name:
                kind = role
                if dx_role is not None and last == dx_role.replace("dx",
                                                                   "dw"):
                    kind = dx_role
                break
        else:
            continue
        ms[kind] += dur
        by_symbol[symbol] += 1
        if body != "sum":
            count[kind] += 1
        last = kind
    return count, ms, by_symbol


def symbol_launches(counted: dict, mma: dict) -> dict:
    """The launches each traced symbol should show, from the launch
    counters of the same step (``counted``, by role) and the tensor-core
    body counters (``mma``, by ``body_counts``'s roles): a family's mma
    symbol takes its mma launches, its FMA symbol the rest; the slice
    sum's launches are not counted and not held."""
    want = {}
    for symbol, role, dx, body in TRACE_KINDS:
        if body == "sum":
            continue
        n_mma = mma.get(role, 0)
        n = counted[role] + (counted[dx] if dx else 0)
        want[symbol] = n_mma if body == "mma" else n - n_mma
    return want


def profile_train_step(trainer, phase: str) -> dict:
    """One training step under torch.profiler: the card's busy share of the
    step and the share of each of the sparse products, split by
    ``split_trace`` and held against the launch counters of the same step.

    A trace can come back without its first kernel records.  So each window
    opens with ``PROFILE_PAD`` spin kernels, which are the records to go
    first; their loss is reported and they count in no time.  A trace
    with fewer launches of a sparse kernel than its counters is reported
    and taken again, up to ``PROFILE_TRIES`` steps; one with more, or
    whose split by role disagrees with the counters, fails at once."""
    from torch.profiler import ProfilerActivity, profile

    lost = []
    for attempt in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        before, before_mma = launch_counts(), body_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PAD):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            trainer.run(1)
        counted = counts_since(before)
        mma = {k: v - before_mma[k] for k, v in body_counts().items()}
        traced = sorted((e.time_range.start,
                         e.time_range.elapsed_us() * 1e-3, e.name)
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA)
        kernels = [k for k in traced if "spin_kernel" not in k[2]]
        pad_lost = PROFILE_PAD - (len(traced) - len(kernels))
        if not kernels:
            raise AssertionError("the profiler recorded no kernel on the "
                                 "card")
        count, ms, by_symbol = split_trace(kernels)
        want = symbol_launches(counted, mma)
        if any(by_symbol[k] > want[k] for k in want):
            raise AssertionError(f"profiled step: trace holds {by_symbol} "
                                 f"launches by kernel, counters {want}")
        if all(by_symbol[k] == want[k] for k in want):
            break
        missing = {k: want[k] - by_symbol[k] for k in want
                   if by_symbol[k] != want[k]}
        lost.append(dict(pad=pad_lost, sparse=missing))
        log(phase, f"profiled step {attempt}: the trace lost kernel records "
                   f"({pad_lost} of {PROFILE_PAD} spin kernels, sparse "
                   f"launches {missing} of {want})")
    else:
        raise AssertionError(f"profiled step: the trace lost kernel records "
                             f"in {PROFILE_TRIES} steps running: {lost}")
    if count != counted:
        raise AssertionError(f"profiled step: trace split {count}, launch "
                             f"counters {counted}")
    wall_ms = 1e3 * trainer.history[-1]["step_time_s"]
    busy = sum(ms for _, ms, _ in kernels)
    return dict(wall_ms=wall_ms, busy_ms=busy, busy_share=busy / wall_ms,
                kernel_ms=ms, kernel_launches=count,
                launches_by_symbol={k: v for k, v in by_symbol.items() if v},
                mma_launches=mma,
                kernel_share={k: v / busy for k, v in ms.items()},
                attempts=attempt, pad_records_lost=pad_lost,
                lost_records=lost)


def phase_train(cfg, want: dict, n_steps: int, batch: int, seq: int,
                phase: str = "train") -> dict:
    """``n_steps`` of ``Trainer.run`` (the defaults of launch/train.py:
    sgdm, lr 3e-2, cosine, clip 1.0, remat on); each step must launch
    ``want``; the first step untimed; then one profiled step (more where
    the trace lost records)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.data import TokenStream
    from repro_torch.models import LMModel
    from repro_torch.train import Trainer

    model = LMModel(cfg, device="cuda", seed=0)
    tcfg = TrainConfig(optimizer="sgdm", lr=3e-2, schedule="cosine",
                       total_steps=n_steps,
                       warmup_steps=min(100, n_steps // 10), grad_clip=1.0)
    trainer = Trainer(model, tcfg, TokenStream(cfg.vocab_size, batch, seq,
                                               seed=0), checkpoint=False)
    counts = []
    trainer.hooks.append(lambda step, metrics: counts.append(
        launch_counts()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    hist = list(trainer.run(n_steps))
    launches = launch_counts()
    # a step's sparse launches all run bf16 at >= 16 tokens (rows an
    # expert) on layouts the tensor-core bodies take, so every one of them
    # must have taken those bodies
    mma = body_counts()
    want_mma = train_mma_counts(launches)
    if mma != want_mma:
        raise AssertionError(f"tensor-core body launches {mma}, want "
                             f"{want_mma}: every launch of a "
                             f"{batch * seq}-token step takes them")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prev = dict.fromkeys(COUNTERS, 0)
    for i, c in enumerate(counts):
        step = {k: c[k] - prev[k] for k in COUNTERS}
        if step != want:
            raise AssertionError(f"step {i}: launches {step}, want {want}")
        prev = c
    if launches != {k: v * n_steps for k, v in want.items()}:
        raise AssertionError(f"{launches} launches in {n_steps} steps")
    for h in hist:
        if not all(np.isfinite(h[k]) for k in ("loss", "grad_norm", "ce",
                                                 "aux")):
            raise AssertionError(f"step {h['step']}: {h}")
    timed = [h["step_time_s"] for h in hist[1:]]
    step_ms = 1e3 * statistics.mean(timed)
    prof = profile_train_step(trainer, phase)
    if prof["kernel_launches"] != want:
        raise AssertionError(f"profiled step launches "
                             f"{prof['kernel_launches']}")
    want_mma = train_mma_counts(want)
    if prof["mma_launches"] != want_mma:
        raise AssertionError(f"profiled step: tensor-core body launches "
                             f"{prof['mma_launches']}, want {want_mma}")
    res = dict(
        steps=n_steps, tokens_per_step=batch * seq,
        losses=[h["loss"] for h in hist], ce=[h["ce"] for h in hist],
        aux=[h["aux"] for h in hist],
        grad_norms=[h["grad_norm"] for h in hist],
        step_ms=[1e3 * t for t in timed], mean_step_ms=step_ms,
        tokens_per_s=batch * seq / (step_ms / 1e3),
        peak_mem_gb=peak_gb,
        launches=launches, launches_per_step=want,
        mma_launches=mma,
        profile=prof,
        busy_share_unprofiled=prof["busy_ms"] / step_ms,
    )
    fmt = lambda xs, f: ", ".join(f"{x:{f}}" for x in xs)
    log(phase, f"{cfg.name}: {n_steps} steps of {batch} x {seq} tokens, "
               f"losses {fmt(res['losses'], '.4f')}; ce "
               f"{fmt(res['ce'], '.4f')}; aux {fmt(res['aux'], '.5f')}; "
               f"grad norms {fmt(res['grad_norms'], '.3f')}")
    log(phase, f"last {len(timed)} steps: {step_ms:.1f} ms/step "
               f"({fmt(res['step_ms'], '.1f')}), "
               f"{res['tokens_per_s']:.0f} tokens/s; peak memory "
               f"{peak_gb:.2f} GB")
    log(phase, f"launches per step, counted at each launch: "
               + ", ".join(f"{k} {v}" for k, v in want.items() if v)
               + f"; in {n_steps} steps {launches}")
    log(phase, f"profiled step (trace {prof['attempts']} of "
               f"{PROFILE_TRIES}, {prof['pad_records_lost']} of "
               f"{PROFILE_PAD} leading spin records lost): "
               f"{prof['wall_ms']:.1f} ms wall, card busy "
               f"{prof['busy_ms']:.1f} ms ({prof['busy_share']:.1%}; "
               f"{res['busy_share_unprofiled']:.1%} of the unprofiled "
               f"step); "
               + ", ".join(f"{k} {prof['kernel_ms'][k]:.1f} ms "
                           f"({prof['kernel_share'][k]:.1%} of busy, "
                           f"{prof['kernel_launches'][k]} launches)"
                           for k in COUNTERS if want[k]))
    log(phase, f"profiled step's launches by kernel symbol (every sparse "
               f"launch of the {batch * seq}-token step on the "
               f"*_mma_kernel symbols; the slice sums count as no "
               f"launch): " + ", ".join(
                   f"{k} {v}" for k, v in
                   prof["launches_by_symbol"].items()))
    print(f"{phase} " + json.dumps(res), flush=True)
    del trainer, model
    free_card()
    return res


class RouterMargins:
    """The smallest top-k margin of the router probabilities (k-th minus
    (k+1)-th) over every MoE layer call of a model, and those probabilities
    call by call, to tell a routing flip from a tolerance miss."""

    def __init__(self, model):
        from repro_torch.models.moe import MoELayer

        self.smallest = float("inf")
        self.probs = []
        self.handles = [m.register_forward_pre_hook(self._hook)
                        for m in model.modules() if isinstance(m, MoELayer)]

    def _hook(self, layer, args):
        x = args[0]
        self.smallest = min(self.smallest, layer.topk_margin(x))
        with torch.no_grad():
            probs = layer.route(x.reshape(-1, x.shape[-1]))[0]
        self.probs.append((probs.cpu(), layer.moe.top_k))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


# The smallest top-k router margin that train parity accepts.  The card's
# router probabilities differ from the CPU's by the hidden state's float32
# summation order, up to 1.31e-6 at full width (PERF.md), so a
# margin under 1e-6 is a tie within that noise.  Above it, the check that
# decides is direct: card and CPU must choose the same top-k experts for
# every token of every router call.
ROUTER_MARGIN = 1e-6


def check_router_margins(margins: dict) -> str:
    """Assert that both runs of a MoE train parity routed every token to
    the same experts, with top-k margins of at least ``ROUTER_MARGIN``;
    return the text that reports them ('' for a model without MoE
    layers)."""
    if not margins["cpu"].handles:
        return ""
    card, cpu = margins["cuda"].probs, margins["cpu"].probs
    if len(card) != len(cpu):
        raise AssertionError(f"router calls: card {len(card)}, cpu {len(cpu)}")
    gap = margin_change = 0.0
    for call, ((a, k), (b, _)) in enumerate(zip(card, cpu)):
        top_a, top_b = torch.topk(a, k + 1), torch.topk(b, k + 1)
        ids_a = top_a.indices[:, :k].sort(-1).values
        ids_b = top_b.indices[:, :k].sort(-1).values
        flipped = (ids_a != ids_b).any(-1)
        if bool(flipped.any()):
            raise AssertionError(f"routing flip: router call {call}, tokens "
                                 f"{flipped.nonzero().flatten().tolist()}: "
                                 f"card and cpu chose different experts")
        gap = max(gap, float((a - b).abs().max()))
        m_a = top_a.values[:, k - 1] - top_a.values[:, k]
        m_b = top_b.values[:, k - 1] - top_b.values[:, k]
        margin_change = max(margin_change, float((m_a - m_b).abs().max()))
    smallest = min(m.smallest for m in margins.values())
    text = (f"; smallest top-k router margin {smallest:.3e} (card "
            f"{margins['cuda'].smallest:.3e}, cpu {margins['cpu'].smallest:.3e},"
            f" over {len(cpu)} router calls each) >= {ROUTER_MARGIN:.0e}, "
            f"no token routed differently; card vs cpu: probabilities "
            f"max|diff| {gap:.2e}, a token's margin max|diff| "
            f"{margin_change:.2e}")
    if not smallest >= ROUTER_MARGIN:
        raise AssertionError("routing within noise of a tie" + text)
    return text


def phase_train_parity(cfg, want: dict, n_layers: int = 2, seq: int = 64,
                       phase: str = "parity") -> None:
    """float32: the same weights and batch train 2 steps on the card (the
    kernels) and on the CPU (the plain versions); each step must launch
    ``want`` on the card and nothing on the CPU.  Without weight decay
    the SGD momentum after the steps is the sum of the clipped gradients,
    so it holds every parameter's gradient, dW and dX included, against
    the CPU's at 1e-4 * max|ref|.  (The parameters' own change is no
    finer test: each update rounds to one float32 spacing of the value,
    which is larger than 1e-4 of the change.)"""
    from repro_torch.configs import TrainConfig
    from repro_torch.data import TokenStream
    from repro_torch.models import LMModel
    from repro_torch.train import Trainer

    cfg = cfg.with_(compute_dtype="float32", n_layers=n_layers)
    gpu = LMModel(cfg, device="cuda", seed=0)
    cpu = LMModel(cfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    tcfg = TrainConfig(optimizer="sgdm", lr=3e-2, schedule="constant",
                       grad_clip=1.0, weight_decay=0.0)
    stream = TokenStream(cfg.vocab_size, 1, seq, seed=0)
    runs, margins = {}, {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        reset_launch_counts()
        margins[name] = RouterMargins(model)
        tr = Trainer(model, tcfg, stream, checkpoint=False)
        hist = tr.run(2)
        margins[name].remove()
        runs[name] = ([h["loss"] for h in hist], tr.state.params,
                      tr.state.opt_state["m"], launch_counts())
    margin = check_router_margins(margins)
    want_launches = {k: 2 * v for k, v in want.items()}
    if runs["cuda"][3] != want_launches or any(runs["cpu"][3].values()):
        raise AssertionError(f"launches: card {runs['cuda'][3]}, cpu "
                             f"{runs['cpu'][3]}, want {want_launches}")
    worst_loss = max(abs(a - b) / abs(b)
                     for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    if not worst_loss <= 1e-4:
        raise AssertionError(f"losses {runs['cuda'][0]} (card) vs "
                             f"{runs['cpu'][0]} (cpu){margin}")
    worst = {}
    for what, idx in (("momentum", 2), ("params", 1)):
        worst[what] = (-1.0, "")
        for name, ref in runs["cpu"][idx].items():
            got = runs["cuda"][idx][name].cpu()
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            if not (scale > 0 and err <= 1e-4 * scale):
                raise AssertionError(f"{what} {name}: max|diff| {err} > "
                                     f"1e-4 * max|ref| {scale}{margin}")
            worst[what] = max(worst[what], (err / scale, name))
    # the split of the launch count: a forward alone launches every
    # projection once; a backward without remat adds one dX and one dW
    batch = {"tokens": stream.batch_at(0)}
    reset_launch_counts()
    with torch.no_grad():
        gpu.loss(batch)
    fwd = launch_counts()
    reset_launch_counts()
    gpu.loss(batch, train=False)[0].backward()
    no_remat = launch_counts()
    one = {k: v for k, v in want.items()}
    for role in ("forward", "stacked_forward", "chain_forward"):
        one[role] = want[role] // 2
    fwd_only = {k: (v if k.endswith("forward") else 0)
                for k, v in one.items()}
    if fwd != fwd_only or no_remat != one:
        raise AssertionError(f"forward alone {fwd} launches, a step without "
                             f"remat {no_remat}")
    log(phase, f"train float32, {cfg.name} with {n_layers} full-width "
               f"layers, 2 steps of 1 x {seq} tokens: losses card "
               f"{runs['cuda'][0]} vs cpu {runs['cpu'][0]} (worst "
               f"{worst_loss:.2e} relative); {len(runs['cpu'][1])} "
               f"parameters: momentum (the clipped gradients) worst "
               f"max|diff|/max|ref| {worst['momentum'][0]:.2e} "
               f"({worst['momentum'][1]}), updated values "
               f"{worst['params'][0]:.2e} ({worst['params'][1]}){margin}")
    log(phase, f"launches on the card: {runs['cuda'][3]} in 2 steps with "
               f"remat; a forward alone {fwd}; a step without remat "
               f"{no_remat}: so a remat step is forward + recompute + dX")
    del gpu, cpu
    free_card()


def per_layer(rows: dict, kind, projections=None) -> dict:
    """One decoder layer's projections (or one VGG19 pass's layers): the
    sums of ``rows`` (keyed ``(layout, kind)``, kind a token count or a
    role) weighted by ``projections`` (tinyllama's seven by default)."""
    projections = projections or LAYER_PROJECTIONS
    fields = ["ms", "plain_ms", "library_ms", "bound_ms"]
    fields += [f for f in ("fma_ms", "mma64_ms", "mma128_ms", "masked_ms")
               if all(f in rows[(key, kind)] for key in projections)]
    agg = {f: 0.0 for f in fields}
    by_share = {"bytes": 0.0, "operations": 0.0}
    for key, count in projections.items():
        row = rows[(key, kind)]
        for f in agg:
            agg[f] += count * row[f]
        by_share[row["bound_by"]] += count * row["bound_ms"]
    agg["bound_by"] = max(by_share, key=by_share.get)
    return agg

def moe_layouts():
    from repro_torch.core import RBGP4Layout, design_rbgp4

    return {key: RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
            for key, (m, k) in MOE_WIDTH.items()}


def phase_check_moe(layouts) -> dict:
    """The stacked kernels against their plain versions at the expert
    layouts with 60 experts: max abs diff per record entry.  The forward
    at ``MOE_CHECK_ROWS`` rows an expert (three epilogues), with
    ``save_preact`` and on the transposed layouts (dX) from 16 rows on,
    where bf16 takes the tensor-core body; dW at ``MOE_CHECK_ROWS``
    (bf16 from 16 rows on the tensor-core body).  In bf16 the forward with
    ``save_preact`` (at decode, without), dX and dW are rerun (the same
    bits), and each expert's Y, Z, dX and dW must be the bits of the
    unstacked launch of the same body (and, for dW, the same plan) on that
    expert's slice."""
    from repro_torch.kernels import (MMA_MIN_TOKENS, KernelTables,
                                     TransposeTables,
                                     rbgp4_sddmm_rhs_stacked,
                                     rbgp4_sddmm_rhs_stacked_reference,
                                     rbgp4mm_rhs_stacked,
                                     rbgp4mm_rhs_stacked_reference, rhs_path,
                                     sddmm_path, stacked_sddmm_mma_plan)
    from repro_torch.kernels.rbgp4mm import _sddmm_body, _sm_count

    g = torch.Generator(device="cuda").manual_seed(5)
    e = MOE_EXPERTS
    max_abs = {"forward": 0.0, "dx": 0.0, "dw": 0.0}
    n_cases = n_bits = 0
    for key, lay in layouts.items():
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        d, d_t = tables.dims, tt.tables.dims
        log("check", f"experts {key:7s} {lay.m} x {lay.k}: G = "
                     f"{d.group_rows}, C = {d.chunk_cols}, "
                     f"{d.d_o * d.d_i} chunks a row; transposed: G = "
                     f"{d_t.group_rows}, C = {d_t.chunk_cols}, "
                     f"{d_t.d_o * d_t.d_i} chunks")
        for dt in (torch.float32, torch.bfloat16):
            rnd = lambda *s: torch.randn(*s, device="cuda",
                                         generator=g).to(dt)
            worst = {"forward": 0.0, "save_preact": 0.0, "transposed": 0.0,
                     "sddmm": 0.0}
            bodies, bodies_dw = {}, {}

            def hold(what, got, want, entry, row):
                err, rel = agree(f"stacked {what} {key}", got, want, dt)
                max_abs[entry] = max(max_abs[entry], err)
                worst[row] = max(worst[row], rel)

            def same_bits(what, tab, call, outs, x, w, b=None, act=None):
                """A rerun of ``call`` gives ``outs`` again, and so does the
                unstacked launch of the body rhs_path picks, expert by
                expert (Y, and Z where given)."""
                nonlocal n_bits
                again = call()
                again = again if isinstance(again, tuple) else (again,)
                for a, o in zip(again, outs):
                    if not torch.equal(a, o):
                        raise AssertionError(f"stacked {what} {key}: a rerun "
                                             f"changed the bits")
                rhs, _ = body_launchers(tab, rhs_path(tab.dims, x.shape[1],
                                                      dt))
                y1 = torch.empty_like(outs[0][0])
                z1 = torch.empty_like(y1) if len(outs) > 1 else None
                for i in range(e):
                    rhs(x[i], w[i], y1, z1, act=act,
                        bias=None if b is None else b[i])
                    for one, o in zip((y1, z1), outs):
                        if not torch.equal(one, o[i]):
                            raise AssertionError(
                                f"stacked {what} {key} expert {i}: not the "
                                f"bits of the unstacked launch")
                n_bits += 1

            def same_dw_bits(n, gy, x, dw):
                """A rerun of the stacked dW gives ``dw`` again, and so
                does the unstacked mma launch of the stacked plan on each
                expert's slice."""
                nonlocal n_bits
                if not torch.equal(rbgp4_sddmm_rhs_stacked(tables, gy, x),
                                   dw):
                    raise AssertionError(f"stacked sddmm {key} N={n}: a "
                                         f"rerun changed the bits")
                plan = stacked_sddmm_mma_plan(d, e, n, _sm_count("cuda"))
                one = torch.empty_like(dw[0])
                for i in range(e):
                    _sddmm_body("mma", tables, gy[i], x[i], one, plan=plan)
                    if not torch.equal(one, dw[i]):
                        raise AssertionError(
                            f"stacked sddmm {key} N={n} expert {i}: not the "
                            f"bits of the unstacked launch")
                n_bits += 1

            w = rnd(e, *lay.data_shape)
            wt = tt.values(w)
            for n in MOE_CHECK_ROWS:
                x = rnd(e, n, lay.k)
                bodies[n] = rhs_path(d, n, dt)
                for act, bias in ((None, False), ("silu", False),
                                  ("gelu", True)):
                    b = rnd(e, lay.m) if bias else None
                    call = lambda: rbgp4mm_rhs_stacked(tables, x, w, bias=b,
                                                       act=act)
                    y = launched(rbgp4mm_rhs_stacked, call)
                    hold(f"N={n} act={act}", y,
                         rbgp4mm_rhs_stacked_reference(tables, x, w, bias=b,
                                                       act=act),
                         "forward", "forward")
                    n_cases += 1
                    if n < MMA_MIN_TOKENS:
                        if dt == torch.bfloat16:
                            same_bits(f"N={n} act={act}", tables, call, (y,),
                                      x, w, b, act)
                        continue
                    # the train path's forward and recompute save Z
                    call = lambda: rbgp4mm_rhs_stacked(
                        tables, x, w, bias=b, act=act, save_preact=True)
                    y, z = launched(rbgp4mm_rhs_stacked, call)
                    wy, wz = rbgp4mm_rhs_stacked_reference(
                        tables, x, w, bias=b, act=act, save_preact=True)
                    hold(f"save_preact N={n} act={act} y", y, wy, "forward",
                         "save_preact")
                    hold(f"save_preact N={n} act={act} z", z, wz, "forward",
                         "save_preact")
                    if dt == torch.bfloat16:
                        same_bits(f"save_preact N={n} act={act}", tables,
                                  call, (y, z), x, w, b, act)
                    n_cases += 1
                gy = rnd(e, n, lay.m)
                bodies_dw[n] = sddmm_path(d, n, dt)
                mma_before = rbgp4_sddmm_rhs_stacked.launches_mma
                dw = launched(rbgp4_sddmm_rhs_stacked,
                              lambda: rbgp4_sddmm_rhs_stacked(tables, gy, x))
                if (rbgp4_sddmm_rhs_stacked.launches_mma - mma_before
                        != (bodies_dw[n] == "mma")):
                    raise AssertionError(f"stacked sddmm {key} N={n}: the "
                                         f"tensor-core counter disagrees "
                                         f"with sddmm_path")
                hold(f"sddmm N={n}", dw,
                     rbgp4_sddmm_rhs_stacked_reference(tables, gy, x),
                     "dw", "sddmm")
                if bodies_dw[n] == "mma":
                    same_dw_bits(n, gy, x, dw)
                n_cases += 1
                if n >= MMA_MIN_TOKENS:
                    call = lambda: rbgp4mm_rhs_stacked(tt.tables, gy, wt)
                    dx = launched(rbgp4mm_rhs_stacked, call, "launches_dx")
                    hold(f"transposed N={n}", dx,
                         rbgp4mm_rhs_stacked_reference(tt.tables, gy, wt),
                         "dx", "transposed")
                    if dt == torch.bfloat16:
                        same_bits(f"transposed N={n}", tt.tables, call,
                                  (dx,), gy, wt)
                    n_cases += 1
                del x, gy
                torch.cuda.empty_cache()
            log("check", f"experts {key:7s} {str(dt):15s} "
                         f"max|diff|/max|ref|: "
                         + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                         + "; forward and dX bodies: " + ", ".join(
                             f"N={n} {b_}" for n, b_ in bodies.items())
                         + "; dW bodies: " + ", ".join(
                             f"N={n} {b_}" for n, b_ in bodies_dw.items()))
    log("check", f"{n_cases} stacked-kernel cases agree (60 experts, one "
                 f"launch each); {n_bits} bf16 forward, dX and dW launches "
                 f"rerun bit-equal and bit-equal, expert by expert, to the "
                 f"unstacked launch of the same body; max abs diff "
                 + ", ".join(f"{k} {v:.3e}" for k, v in max_abs.items()))
    return max_abs


def phase_times_moe(layouts) -> dict:
    """The stacked kernels at the expert layouts, 60 experts, bf16: the
    forward at decode (8 rows an expert, no epilogue), at a training step
    (171 rows, ``save_preact`` and silu: Y and Z written) and at a
    full-capacity prefill (512 rows, no epilogue), dX and dW at 171;
    kernel, plain version, ``torch.bmm`` on the unpacked dense (E, M, K)
    weights, bound.  Where the kernel takes the tensor-core body, the FMA
    body on the same operands (``fma_ms``) and, at 171 rows, the
    tensor-core body with each token tile (``mma64_ms``, ``mma128_ms``;
    the wrapper takes ``stacked_mma_block_tokens``'); dW beside its FMA
    body."""
    from repro_torch.kernels import (KernelTables, TransposeTables,
                                     rbgp4_sddmm_rhs_stacked,
                                     rbgp4_sddmm_rhs_stacked_reference,
                                     rbgp4mm_rhs_stacked,
                                     rbgp4mm_rhs_stacked_reference, rhs_path,
                                     sddmm_path, stacked_sddmm_tile)
    from repro_torch.kernels.ref import unpack_dense

    g = torch.Generator(device="cuda").manual_seed(6)
    dt, e = torch.bfloat16, MOE_EXPERTS
    rows = {}

    def yardsticks(tab, n, xin, w, out, z=None, act=None):
        """fma_ms (and, at a training step, mma64_ms) of the other bodies
        on the kernel's operands, where the kernel takes the mma body."""
        if rhs_path(tab.dims, n, dt) != "mma":
            return {}
        fma = stacked_body_launcher(tab, "fma")
        got = {"fma_ms": time_cuda(lambda i: fma(xin, w(i), out, z, act))}
        if n == MOE_ROWS["train"]:
            for bn in (64, 128):
                mma = stacked_body_launcher(tab, "mma", block_tokens=bn)
                got[f"mma{bn}_ms"] = time_cuda(
                    lambda i: mma(xin, w(i), out, z, act))
        return got

    def show(t):
        return "".join(f", {name} {t[k]:.4f} ms" for k, name in (
            ("fma_ms", "FMA body"), ("mma64_ms", "64-token tile"),
            ("mma128_ms", "128-token tile")) if k in t)

    for key, lay in layouts.items():
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        dims, dims_t = tables.dims, tt.tables.dims
        m, k = lay.m, lay.k
        nnz = lay.data_shape[1]
        copies = max(2, -(-2 * L2_BYTES // (e * m * nnz * 2)))
        ws = torch.randn((copies, e, m, nnz), device="cuda",
                         generator=g).to(dt)
        wd = unpack_dense(lay, ws)                       # (copies, E, M, K)
        c = lambda i: i % copies
        chunks = dims.d_o * dims.d_i
        for role, n in MOE_ROWS.items():
            x = torch.randn((e, n, k), device="cuda", generator=g).to(dt)
            train = role == "train"
            act, n_out = ("silu", 2) if train else (None, 1)
            out = torch.empty((e, n, m), dtype=dt, device="cuda")
            z = torch.empty_like(out) if train else None
            t = yardsticks(tables, n, x, lambda i: ws[c(i)], out, z, act)
            t["ms"] = time_cuda(lambda i: rbgp4mm_rhs_stacked(
                tables, x, ws[c(i)], act=act, save_preact=train))
            t["plain_ms"] = time_cuda(lambda i: rbgp4mm_rhs_stacked_reference(
                tables, x, ws[c(i)], act=act, save_preact=train))
            t["library_ms"] = time_cuda(lambda i: torch.bmm(
                x, wd[c(i)].transpose(1, 2)))
            b, by = bound_ms(n, m, k, nnz, chunks, dims.group_rows, 2, e=e,
                             n_out=n_out)
            rows[(key, n)] = dict(t, bound_ms=b, bound_by=by)
            log("times", f"experts {key:7s} N={n:<4d} ({role}"
                         f"{', save_preact, silu' if train else ''}) bf16 "
                         f"[{rhs_path(dims, n, dt)} body]: kernel "
                         f"{t['ms']:.4f} ms{show(t)}, plain "
                         f"{t['plain_ms']:.4f} ms, torch.bmm dense "
                         f"{t['library_ms']:.4f} ms, bound {b * 1e3:.2f} us "
                         f"({by})")
            del out, z
            if not train:
                del x
                continue
            gy = torch.randn((e, n, m), device="cuda", generator=g).to(dt)
            wt = [tt.values(ws[i]) for i in range(copies)]
            dx_out = torch.empty((e, n, k), dtype=dt, device="cuda")
            dw_out = torch.empty((e, m, nnz), dtype=dt, device="cuda")
            fma_dw = stacked_sddmm_launcher(tables, "fma")
            t = dict(
                dw_fma=time_cuda(lambda i: fma_dw(gy, x, dw_out)),
                dw=time_cuda(lambda i: rbgp4_sddmm_rhs_stacked(tables, gy,
                                                               x)),
                dw_plain=time_cuda(lambda i: rbgp4_sddmm_rhs_stacked_reference(
                    tables, gy, x)),
                dw_lib=time_cuda(lambda i: torch.bmm(gy.transpose(1, 2), x)),
            )
            b, by = sddmm_bound_ms(n, m, k, nnz, chunks, dims.group_rows, 2,
                                   e=e)
            rows[(key, "dw")] = dict(ms=t["dw"], plain_ms=t["dw_plain"],
                                     library_ms=t["dw_lib"], bound_ms=b,
                                     bound_by=by, fma_ms=t["dw_fma"])
            log("times", f"dW experts {key:7s} N={n} bf16 "
                         f"[{sddmm_path(dims, n, dt)} body, tile "
                         f"{stacked_sddmm_tile(dims, n)}]: kernel "
                         f"{t['dw']:.4f} ms, FMA body {t['dw_fma']:.4f} ms, "
                         f"plain {t['dw_plain']:.4f} ms, torch.bmm g^T @ x "
                         f"dense {t['dw_lib']:.4f} ms, bound "
                         f"{b * 1e3:.2f} us ({by})")
            t = yardsticks(tt.tables, n, gy, lambda i: wt[c(i)], dx_out)
            t["ms"] = time_cuda(lambda i: rbgp4mm_rhs_stacked(
                tt.tables, gy, wt[c(i)]))
            t["plain_ms"] = time_cuda(lambda i: rbgp4mm_rhs_stacked_reference(
                tt.tables, gy, wt[c(i)]))
            t["library_ms"] = time_cuda(lambda i: torch.bmm(gy, wd[c(i)]))
            b, by = bound_ms(n, dims_t.m, dims_t.k, dims_t.data_cols,
                             dims_t.d_o * dims_t.d_i, dims_t.group_rows, 2,
                             e=e)
            rows[(key, "dx")] = dict(t, bound_ms=b, bound_by=by)
            log("times", f"dX experts {key:7s} N={n} bf16 (G = "
                         f"{dims_t.group_rows}, C = {dims_t.chunk_cols}) "
                         f"[{rhs_path(dims_t, n, dt)} body]: kernel "
                         f"{t['ms']:.4f} ms{show(t)}, plain "
                         f"{t['plain_ms']:.4f} ms, torch.bmm g @ W dense "
                         f"{t['library_ms']:.4f} ms, bound {b * 1e3:.2f} us "
                         f"({by})")
            del gy, wt, dx_out, dw_out, x
        del ws, wd
        torch.cuda.empty_cache()
    return rows


def phase_stacked_tiles(layouts, ns=STACKED_TILE_ROWS) -> dict:
    """``rbgp4mm_rhs_stacked``'s tensor-core body with 64- and 128-token
    tiles on the same operands: the forward (no epilogue) and dX at the
    expert layouts, 60 experts, bf16, ``ns`` rows an expert; each tile's
    result held against the plain version and the two bit-equal, then
    both timed (CUDA events, weights cycled past the L2).  Returns
    {(kind, n): {64: ms, 128: ms}} summed over one MoE layer's three
    projections: the measurement ``stacked_mma_block_tokens`` is set
    from."""
    from repro_torch.kernels import (KernelTables, TransposeTables,
                                     rbgp4mm_rhs_stacked_reference,
                                     stacked_mma_block_tokens)

    g = torch.Generator(device="cuda").manual_seed(9)
    dt, e = torch.bfloat16, MOE_EXPERTS
    tiles = (64, 128)
    layer = {(kind, n): dict.fromkeys(tiles, 0.0)
             for kind in ("fwd", "dx") for n in ns}
    for key, lay in layouts.items():
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        count = MOE_LAYER_PROJECTIONS[key]
        copies = max(2, -(-2 * L2_BYTES // (e * lay.m * lay.data_shape[1]
                                            * 2)))
        ws = torch.randn((copies, e, *lay.data_shape), device="cuda",
                         generator=g).to(dt)
        wts = torch.stack([tt.values(ws[i]) for i in range(copies)])
        for n in ns:
            x = torch.randn((e, n, lay.k), device="cuda", generator=g).to(dt)
            gy = torch.randn((e, n, lay.m), device="cuda",
                             generator=g).to(dt)
            calls = {"fwd": (tables, x, ws, lay.m), "dx": (tt.tables, gy, wts,
                                                           lay.k)}
            line = []
            for kind, (tab, xin, w, width) in calls.items():
                want = rbgp4mm_rhs_stacked_reference(tab, xin, w[0])
                outs = {}
                for bn in tiles:
                    run = stacked_body_launcher(tab, "mma", block_tokens=bn)
                    outs[bn] = torch.empty((e, n, width), dtype=dt,
                                           device="cuda")
                    run(xin, w[0], outs[bn])
                    torch.cuda.synchronize()
                    agree(f"stacked tile {bn} {kind} {key} N={n}", outs[bn],
                          want, dt)
                    ms = time_cuda(lambda i: run(xin, w[i % copies],
                                                 outs[bn]))
                    layer[(kind, n)][bn] += count * ms
                if not torch.equal(outs[64], outs[128]):
                    raise AssertionError(f"stacked {kind} {key} N={n}: the "
                                         f"token tile changed the bits")
                line.append(f"{kind} 64 {layer[(kind, n)][64]:.4f} / 128 "
                            f"{layer[(kind, n)][128]:.4f}")
            del x, gy
        del ws, wts
        torch.cuda.empty_cache()
    for n in ns:
        log("times", f"stacked tiles per MoE layer N={n:<4d}: " + ", ".join(
            f"{kind} 64-token {layer[(kind, n)][64]:.4f} / 128-token "
            f"{layer[(kind, n)][128]:.4f} ms (faster "
            f"{min(tiles, key=layer[(kind, n)].get)}, the wrapper takes "
            f"{stacked_mma_block_tokens(n, kind == 'dx')})"
            for kind in ("fwd", "dx")))
    return layer


def phase_stacked_dw_tiles(layouts, ns=STACKED_TILE_ROWS) -> dict:
    """``rbgp4_sddmm_rhs_stacked``'s tensor-core body with each (block
    columns, stage tokens) of ``STACKED_SDDMM_TILES`` on the same operands
    at the expert layouts, 60 experts, bf16, ``ns`` rows an expert: each
    tile's dW held against the plain version, the tiles of one stage size
    bit-equal (the columns a block owns change no sum), then each timed
    (CUDA events).  Returns {(layout, n, tile): ms}, the measurement
    ``stacked_sddmm_tile`` is set from; logs each layout's fastest tile
    and, per MoE layer (three projections), the wrapper's tiles against
    the fastest ones."""
    from repro_torch.kernels import (KernelTables,
                                     rbgp4_sddmm_rhs_stacked_reference,
                                     sddmm_mma_plan, stacked_sddmm_tile)
    from repro_torch.kernels.rbgp4mm import STACKED_SDDMM_TILES, _sm_count

    g = torch.Generator(device="cuda").manual_seed(10)
    dt, e = torch.bfloat16, MOE_EXPERTS
    sms = _sm_count("cuda")
    times, chosen = {}, {}
    for key, lay in layouts.items():
        tables = KernelTables.build(lay, "cuda")
        d = tables.dims
        for n in ns:
            x = torch.randn((e, n, lay.k), device="cuda", generator=g).to(dt)
            gy = torch.randn((e, n, lay.m), device="cuda",
                             generator=g).to(dt)
            want = rbgp4_sddmm_rhs_stacked_reference(tables, gy, x)
            by_stage = {}
            line = []
            for tile in STACKED_SDDMM_TILES:
                plan = sddmm_mma_plan(d, n, sms, e, tile)
                run = stacked_sddmm_launcher(tables, "mma", plan)
                out = torch.empty((e, *lay.data_shape), dtype=dt,
                                  device="cuda")
                run(gy, x, out)
                torch.cuda.synchronize()
                agree(f"stacked dW tile {tile} {key} N={n}", out, want, dt)
                first = by_stage.setdefault(tile[1], out)
                if not torch.equal(first, out):
                    raise AssertionError(f"stacked dW {key} N={n}: the block "
                                         f"columns changed the bits")
                ms = time_cuda(lambda i: run(gy, x, out))
                times[(key, n, tile)] = ms
                line.append(f"{tile[0]}x{tile[1]} {ms:.4f}")
            chosen[(key, n)] = stacked_sddmm_tile(d, n)
            best = min(STACKED_SDDMM_TILES, key=lambda t: times[(key, n, t)])
            log("times", f"stacked dW tiles {key:7s} N={n:<4d} (block "
                         f"columns x stage tokens, ms): " + ", ".join(line)
                         + f"; fastest {best}, the wrapper takes "
                           f"{chosen[(key, n)]}")
            del x, gy, want, by_stage, out
        torch.cuda.empty_cache()
    for n in ns:
        took = sum(MOE_LAYER_PROJECTIONS[key] * times[(key, n, chosen[(key,
                                                                        n)])]
                   for key in layouts)
        best = sum(MOE_LAYER_PROJECTIONS[key]
                   * min(times[(key, n, t)] for t in STACKED_SDDMM_TILES)
                   for key in layouts)
        log("times", f"stacked dW per MoE layer N={n:<4d}: the wrapper's "
                     f"tiles {took:.4f} ms, the fastest tiles "
                     f"{best:.4f} ms")
    return times


def chain_plan():
    """The one-rule hierarchical-block plan (benchmarks/chain_executor.py)."""
    from repro_torch.sparsity import PatternSpec, SparsityPlan

    return SparsityPlan.uniform(PatternSpec(
        pattern="rbgp", sparsity=CHAIN_SPARSITY, backend="auto",
        factors=HIER, min_dim=CHAIN_MIN_DIM), note="hierarchical-block chain")


def chain_config(compute_dtype: str = "bfloat16"):
    from repro_torch.configs import apply_sparsity, get_config

    cfg = apply_sparsity(get_config("tinyllama-1.1b"), plan=chain_plan())
    return cfg.with_(compute_dtype=compute_dtype)


def chain_layouts() -> dict:
    """tinyllama's four projection shapes under the plan, then the two
    smaller chains of the CPU tests."""
    from repro_torch.core import ChainLayout, design_rbgp

    out = {key: ChainLayout(design_rbgp(m, k, CHAIN_SPARSITY, factors=HIER,
                                        seed=0))
           for key, (m, k) in FULL_WIDTH.items()}
    for key, (m, k, factors) in SMALL_CHAINS.items():
        out[key] = ChainLayout(design_rbgp(m, k, 0.875, factors=factors,
                                           seed=0))
    return out


def phase_check_chain(layouts) -> dict:
    """The chain kernels against their plain versions: ``chainmm_rhs`` at
    N in {1, 8, 16, 77, 512, 1037, 4096} and on the transposed layouts at
    N in {16, 77, 512, 1037, 4096}, ``chain_sddmm_rhs`` at
    ``CHAIN_CHECK_ROWS`` (bf16 from 16 tokens on the tensor-core bodies
    over row-group classes), f32 and bf16, at tinyllama's four layouts;
    smaller N at the two test chains (the FMA bodies).  Every dW, and in
    bf16 every forward and dX on the tensor-core body, is rerun and must
    give the same bits.  Max abs diff per record entry."""
    from repro_torch.kernels import (chain_rhs_path, chain_sddmm_rhs,
                                     chain_sddmm_rhs_reference,
                                     chain_tables, chain_transpose_tables,
                                     chainmm_rhs, chainmm_rhs_reference)
    from repro_torch.kernels.chainmm import chain_sddmm_path

    g = torch.Generator(device="cuda").manual_seed(7)
    max_abs = {"forward": 0.0, "dx": 0.0, "dw": 0.0}
    n_cases = 0
    for key, lay in layouts.items():
        full = key in FULL_WIDTH
        tables = chain_tables(lay, "cuda")
        tt = chain_transpose_tables(lay, "cuda")
        t_ = tt.tables
        cl = tables.classes
        log("check-chain", f"chain {key:8s} {lay.m} x {lay.k}: G = "
                     f"{tables.group_rows}, C = {tables.chunk_cols}, "
                     f"{tables.n_chunks} chunks a row, {cl.n_classes} "
                     f"row-group classes of up to {cl.max_groups} row "
                     f"groups; transposed: G = "
                     f"{t_.group_rows}, C = {t_.chunk_cols}, "
                     f"{t_.n_chunks} chunks")
        for dt in (torch.float32, torch.bfloat16):
            rnd = lambda *s: torch.randn(*s, device="cuda",
                                         generator=g).to(dt)
            worst = {"forward": 0.0, "transposed": 0.0, "sddmm": 0.0}

            def hold(what, got, want, entry, row):
                err, rel = agree(f"chain {what} {key}", got, want, dt)
                max_abs[entry] = max(max_abs[entry], err)
                worst[row] = max(worst[row], rel)

            w = rnd(*lay.data_shape)
            wt = tt.values(w)
            bodies = {"forward": {}, "transposed": {}, "sddmm": {}}

            def rhs_case(tab, what, n, xin, win, attr):
                """One counted launch on ``tab``, held against the plain
                version; on the tensor-core body, counted in
                ``launches_mma`` and rerun bit-equal."""
                path = bodies[what][n] = chain_rhs_path(tab, n, dt)
                before = chainmm_rhs.launches_mma
                call = lambda: chainmm_rhs(tab, xin, win)
                y = launched(chainmm_rhs, call, attr)
                if chainmm_rhs.launches_mma - before != (path == "mma"):
                    raise AssertionError(f"chain {what} {key} N={n}: the "
                                         f"tensor-core counter disagrees "
                                         f"with chain_rhs_path")
                hold(f"{what} N={n}", y, chainmm_rhs_reference(tab, xin, win),
                     "forward" if what == "forward" else "dx", what)
                if path == "mma" and not torch.equal(y, call()):
                    raise AssertionError(f"chain {what} {key} N={n}: a rerun "
                                         f"changed the bits")

            for n in ((1, 8) + CHAIN_CHECK_ROWS[1:] if full else (1, 8, 512)):
                rhs_case(tables, "forward", n, rnd(n, lay.k), w, "launches")
                n_cases += 1
            for n in (CHAIN_CHECK_ROWS[1:] if full else (512,)):
                rhs_case(t_, "transposed", n, rnd(n, lay.m), wt,
                         "launches_dx")
                n_cases += 1
            for n in (CHAIN_CHECK_ROWS if full else (8, 512)):
                gy, x = rnd(n, lay.m), rnd(n, lay.k)
                dw = launched(chain_sddmm_rhs,
                              lambda: chain_sddmm_rhs(tables, gy, x))
                hold(f"sddmm N={n}", dw,
                     chain_sddmm_rhs_reference(tables, gy, x), "dw", "sddmm")
                # no atomics, a fixed order of sums: a rerun, same bits
                if not torch.equal(dw, chain_sddmm_rhs(tables, gy, x)):
                    raise AssertionError(f"chain sddmm {key} N={n} {dt}: a "
                                         f"rerun changed the bits")
                bodies["sddmm"][n] = chain_sddmm_path(tables, n, dt)
                n_cases += 1
            log("check-chain", f"chain {key:8s} {str(dt):15s} max|diff|/max|ref|: "
                         + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
                         + "; bodies: " + "; ".join(
                             f"{k} " + ", ".join(f"N={n} {b}"
                                                 for n, b in v.items())
                             for k, v in bodies.items()))
        torch.cuda.empty_cache()
    log("check-chain", f"{n_cases} chain-kernel cases agree (one launch "
                 f"each), every dW and every bf16 forward and dX on the "
                 f"tensor-core body bit-equal on a rerun; max abs diff "
                 + ", ".join(f"{k} {v:.3e}" for k, v in max_abs.items()))
    return max_abs


def phase_times_chain(layouts, n_train: int = 4096) -> dict:
    """The chain kernels at tinyllama's four layouts, bf16: the forward at
    N = 8 and 512, and at a training step's N (the forward and its remat
    recompute) with dX and dW; kernel, plain version, one PyTorch call on
    the unpacked dense weights (``F.linear``, ``g @ W``, ``g^T @ x``),
    bound; at the training step each also on its FMA body on the same
    operands (``fma_ms``), the tensor-core bodies' yardstick."""
    from repro_torch.kernels import (chain_rhs_path, chain_sddmm_rhs,
                                     chain_sddmm_rhs_reference,
                                     chain_tables, chain_transpose_tables,
                                     chainmm_rhs, chainmm_rhs_reference)
    from repro_torch.kernels.chainmm import (chain_sddmm_path,
                                             chain_unpack_dense)

    g = torch.Generator(device="cuda").manual_seed(8)
    dt = torch.bfloat16
    rows = {}
    for key in FULL_WIDTH:
        lay = layouts[key]
        tables = chain_tables(lay, "cuda")
        tt = chain_transpose_tables(lay, "cuda")
        t_ = tt.tables
        m, k = lay.m, lay.k
        nnz = lay.data_shape[1]
        copies = max(2, -(-2 * L2_BYTES // (m * nnz * 2)))
        ws = torch.randn((copies, m, nnz), device="cuda", generator=g).to(dt)
        dense_copies = max(2, -(-2 * L2_BYTES // (m * k * 2)))
        wd = torch.stack([chain_unpack_dense(lay, ws[i % copies])
                          for i in range(dense_copies)])
        for n in (8, 512):
            x = torch.randn((n, k), device="cuda", generator=g).to(dt)
            t_kernel = time_cuda(lambda i: chainmm_rhs(
                tables, x, ws[i % copies]))
            t_plain = time_cuda(lambda i: chainmm_rhs_reference(
                tables, x, ws[i % copies]))
            t_lib = time_cuda(lambda i: F.linear(x, wd[i % dense_copies]))
            b, by = bound_ms(n, m, k, nnz, tables.n_chunks,
                             tables.group_rows, 2)
            rows[(key, n)] = dict(ms=t_kernel, plain_ms=t_plain,
                                  library_ms=t_lib, bound_ms=b, bound_by=by)
            log("times-chain", f"chain {key:8s} N={n:<4d} bf16 "
                         f"[{chain_rhs_path(tables, n, dt)} body]: kernel "
                         f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms, "
                         f"F.linear dense {t_lib:.4f} ms, bound "
                         f"{b * 1e3:.2f} us ({by})")
        n = n_train
        c_ = max(2, -(-2 * L2_BYTES // ((n * m + n * k) * 2)))
        gs = torch.randn((c_, n, m), device="cuda", generator=g).to(dt)
        xs = torch.randn((c_, n, k), device="cuda", generator=g).to(dt)
        w, wdd = ws[0], wd[0]
        wt = tt.values(w)
        c = lambda i: i % c_
        fma_rhs, fma_sddmm = chain_body_launchers(tables, "fma")
        fma_rhs_t, _ = chain_body_launchers(t_, "fma")
        dw_out = torch.empty((m, nnz), dtype=dt, device="cuda")
        y_out = torch.empty((n, m), dtype=dt, device="cuda")
        dx_out = torch.empty((n, k), dtype=dt, device="cuda")
        t = dict(
            fwd_fma=time_cuda(lambda i: fma_rhs(xs[c(i)], w, y_out)),
            fwd=time_cuda(lambda i: chainmm_rhs(tables, xs[c(i)], w)),
            fwd_plain=time_cuda(lambda i: chainmm_rhs_reference(
                tables, xs[c(i)], w)),
            fwd_lib=time_cuda(lambda i: F.linear(xs[c(i)], wdd)),
            dx_fma=time_cuda(lambda i: fma_rhs_t(gs[c(i)], wt, dx_out)),
            dw_fma=time_cuda(lambda i: fma_sddmm(gs[c(i)], xs[c(i)],
                                                 dw_out)),
            dw=time_cuda(lambda i: chain_sddmm_rhs(tables, gs[c(i)],
                                                   xs[c(i)])),
            dw_plain=time_cuda(lambda i: chain_sddmm_rhs_reference(
                tables, gs[c(i)], xs[c(i)])),
            dw_lib=time_cuda(lambda i: gs[c(i)].T @ xs[c(i)]),
            dx=time_cuda(lambda i: chainmm_rhs(t_, gs[c(i)], wt)),
            dx_plain=time_cuda(lambda i: chainmm_rhs_reference(
                t_, gs[c(i)], wt)),
            dx_lib=time_cuda(lambda i: gs[c(i)] @ wdd),
        )
        b, by = bound_ms(n, m, k, nnz, tables.n_chunks, tables.group_rows, 2)
        rows[(key, "fwd")] = dict(ms=t["fwd"], plain_ms=t["fwd_plain"],
                                  library_ms=t["fwd_lib"], bound_ms=b,
                                  bound_by=by, fma_ms=t["fwd_fma"])
        log("times-chain", f"chain forward {key:8s} N={n} bf16 "
                     f"[{chain_rhs_path(tables, n, dt)} body, "
                     f"{tables.classes.n_classes} classes]: kernel "
                     f"{t['fwd']:.4f} ms, FMA body {t['fwd_fma']:.4f} ms, "
                     f"plain {t['fwd_plain']:.4f} ms, F.linear dense "
                     f"{t['fwd_lib']:.4f} ms, bound {b * 1e3:.2f} us ({by})")
        b, by = sddmm_bound_ms(n, m, k, nnz, tables.n_chunks,
                               tables.group_rows, 2)
        rows[(key, "dw")] = dict(ms=t["dw"], plain_ms=t["dw_plain"],
                                 library_ms=t["dw_lib"], bound_ms=b,
                                 bound_by=by, fma_ms=t["dw_fma"])
        log("times-chain", f"chain dW {key:8s} N={n} bf16 "
                     f"[{chain_sddmm_path(tables, n, dt)} body]: kernel "
                     f"{t['dw']:.4f} ms, FMA body {t['dw_fma']:.4f} ms, "
                     f"plain {t['dw_plain']:.4f} ms, g^T @ x dense "
                     f"{t['dw_lib']:.4f} ms, bound {b * 1e3:.2f} us ({by})")
        b, by = bound_ms(n, t_.m, t_.k, t_.data_cols, t_.n_chunks,
                         t_.group_rows, 2)
        rows[(key, "dx")] = dict(ms=t["dx"], plain_ms=t["dx_plain"],
                                 library_ms=t["dx_lib"], bound_ms=b,
                                 bound_by=by, fma_ms=t["dx_fma"])
        log("times-chain", f"chain dX {key:8s} N={n} bf16 (G = {t_.group_rows}, "
                     f"C = {t_.chunk_cols}) [{chain_rhs_path(t_, n, dt)} "
                     f"body]: kernel {t['dx']:.4f} ms, FMA body "
                     f"{t['dx_fma']:.4f} ms, plain "
                     f"{t['dx_plain']:.4f} ms, g @ W dense "
                     f"{t['dx_lib']:.4f} ms, bound {b * 1e3:.2f} us ({by})")
        del ws, wd, gs, xs, wt, dw_out, y_out, dx_out
        torch.cuda.empty_cache()
    return rows


# -- the feature-major path: VGG19-CIFAR's sparse convs as O = W_s . I ------

def fm_layouts(sparsity: float = 0.75) -> dict:
    """VGG19-CIFAR's seven distinct sparse layouts (in network order; 512 x
    4608 runs at two N) and WRN-40-4's 64 x 144, each ``design_rbgp4(m, k,
    sparsity)`` with its default seed, as the reference's Table 1 designs
    them."""
    from repro_torch.core import RBGP4Layout, design_rbgp4

    shapes = list(dict.fromkeys((m, k) for m, k, _ in VGG19_SDMM))
    return {(m, k): RBGP4Layout(design_rbgp4(m, k, sparsity))
            for m, k in shapes + [WRN_SDMM]}


def phase_check_fm(layouts, dtypes=(torch.float32, torch.bfloat16),
                   ns=FM_CHECK_N, label="") -> dict:
    """``rbgp4mm`` and ``rbgp4_sddmm`` against their plain versions at the
    ``layouts``, in each of ``dtypes``: the forward at N in ``ns`` (by
    default ``FM_CHECK_N``: 1, the least N of the tensor-core bodies,
    ragged token tiles of them and N not a multiple of 8, which keeps bf16
    on the FMA bodies), dI on the transposed tables and dW at each N but
    1, each dW again and bit for bit.  Each launch moves its counter by
    one, and its tensor-core counter by one exactly where
    ``fm_path``/``fm_sddmm_path`` name that body.  Max abs diff per record
    entry."""
    from repro_torch.kernels import (KernelTables, TransposeTables, fm_path,
                                     fm_sddmm_path, rbgp4_sddmm,
                                     rbgp4_sddmm_reference, rbgp4mm,
                                     rbgp4mm_reference)

    g = torch.Generator(device="cuda").manual_seed(9)
    max_abs = {"forward": 0.0, "dx": 0.0, "dw": 0.0}
    n_cases = n_mma = 0
    for (m, k), lay in layouts.items():
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        d, d_t = tables.dims, tt.tables.dims
        log("check-fm", f"{label}{m} x {k}: G = {d.group_rows}, C = "
                        f"{d.chunk_cols}, {d.d_o * d.d_i} slots a row; "
                        f"transposed: G = {d_t.group_rows}, C = "
                        f"{d_t.chunk_cols}, {d_t.d_o * d_t.d_i} slots")
        for dt in dtypes:
            rnd = lambda *sh: torch.randn(*sh, device="cuda",
                                          generator=g).to(dt)
            worst = {"forward": 0.0, "dx": 0.0, "dw": 0.0}
            bodies = []

            def hold(what, got, want, entry):
                err, rel = agree(f"fm {what} {m} x {k}", got, want, dt)
                max_abs[entry] = max(max_abs[entry], err)
                worst[entry] = max(worst[entry], rel)

            def counted(counter, fn, attr, mma):
                before = counter.launches_mma
                out = launched(counter, fn, attr)
                if counter.launches_mma != before + int(mma):
                    raise AssertionError(f"{m} x {k} {dt}: {attr} took "
                                         f"the wrong body")
                return out

            w = rnd(*lay.data_shape)
            wt = tt.values(w)
            for n in ns:
                x = rnd(k, n)
                mma = (fm_path(d, n, dt) == "mma",
                       fm_path(d_t, n, dt) == "mma",
                       fm_sddmm_path(d, n, dt) == "mma")
                o = counted(rbgp4mm, lambda: rbgp4mm(tables, x, w),
                            "launches", mma[0])
                hold(f"forward N={n}", o, rbgp4mm_reference(tables, x, w),
                     "forward")
                n_cases += 1
                n_mma += mma[0]
                if n == 1:
                    bodies.append(f"N={n} {'fma' if not mma[0] else 'mma'}")
                    continue
                gy = rnd(m, n)
                dx = counted(rbgp4mm, lambda: rbgp4mm(tt.tables, gy, wt),
                             "launches_dx", mma[1])
                hold(f"dI N={n}", dx, rbgp4mm_reference(tt.tables, gy, wt),
                     "dx")
                dw = counted(rbgp4_sddmm,
                             lambda: rbgp4_sddmm(tables, gy, x),
                             "launches", mma[2])
                hold(f"dW N={n}", dw, rbgp4_sddmm_reference(tables, gy, x),
                     "dw")
                again = launched(rbgp4_sddmm,
                                 lambda: rbgp4_sddmm(tables, gy, x))
                if not torch.equal(dw, again):
                    raise AssertionError(f"rbgp4_sddmm {m} x {k} N={n} "
                                         f"{dt}: a rerun changed the bits")
                n_cases += 3
                n_mma += sum(mma)
                bodies.append(f"N={n} " + "/".join(
                    "mma" if b else "fma" for b in mma))
            log("check-fm", f"{label}{m} x {k} {str(dt):15s} "
                            f"max|diff|/max|ref|: "
                            + ", ".join(f"{e} {v:.2e}"
                                        for e, v in worst.items())
                            + f"; bodies (O/dI/dW) " + ", ".join(bodies))
        torch.cuda.empty_cache()
    log("check-fm", f"{label}{n_cases} feature-major cases agree (one launch "
                    f"each, {n_mma} on the tensor-core bodies), dW "
                    f"bit-equal on every rerun; max abs diff "
                    + ", ".join(f"{e} {v:.3e}" for e, v in max_abs.items()))
    return max_abs


def phase_times_fm(layouts, max_abs: dict) -> dict:
    """VGG19's eight distinct layer shapes (m, k, n), n at batch 256, bf16:
    the forward, dI and dW kernels, their plain versions, one
    ``torch.matmul`` each on the unpacked dense weights (``W @ I``,
    ``W^T @ dO``, ``dO @ I^T``; timed here, never called by the port), and
    the bounds.  Before the timing, each kernel's output is held against
    its plain version's on the same inputs (these are the shapes the main
    path gives the kernels), folding the max abs diff into ``max_abs``,
    and dW is rerun bit-equal.  Rows keyed ``((m, k, n), role)``."""
    from repro_torch.kernels import (KernelTables, TransposeTables, fm_path,
                                     fm_sddmm_path, rbgp4_sddmm,
                                     rbgp4_sddmm_reference, rbgp4mm,
                                     rbgp4mm_reference)
    from repro_torch.kernels.rbgp4mm import _fm_body, _fm_sddmm_body
    from repro_torch.kernels.ref import unpack_dense

    g = torch.Generator(device="cuda").manual_seed(10)
    dt = torch.bfloat16
    rows = {}
    for m, k, n in dict.fromkeys(VGG19_SDMM):
        lay = layouts[(m, k)]
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        d, d_t = tables.dims, tt.tables.dims
        nnz = lay.data_shape[1]
        bodies = {"fwd": fm_path(d, n, dt), "dx": fm_path(d_t, n, dt),
                  "dw": fm_sddmm_path(d, n, dt)}
        # operands cycled through more than the 50 MB L2 cache
        copies = max(1, -(-2 * L2_BYTES // ((k + m) * n * 2)))
        xs = torch.randn((copies, k, n), device="cuda", generator=g).to(dt)
        gs = torch.randn((copies, m, n), device="cuda", generator=g).to(dt)
        w = torch.randn((m, nnz), device="cuda", generator=g).to(dt)
        wt, wd = tt.values(w), unpack_dense(lay, w)
        held = {
            "forward": (lambda: rbgp4mm(tables, xs[0], w),
                        lambda: rbgp4mm_reference(tables, xs[0], w)),
            "dx": (lambda: rbgp4mm(tt.tables, gs[0], wt),
                   lambda: rbgp4mm_reference(tt.tables, gs[0], wt)),
            "dw": (lambda: rbgp4_sddmm(tables, gs[0], xs[0]),
                   lambda: rbgp4_sddmm_reference(tables, gs[0], xs[0])),
        }
        rel = {}
        for entry, (kernel, plain) in held.items():
            got = kernel()
            err, rel[entry] = agree(f"times-fm {entry} {m} x {k} N={n}",
                                    got, plain(), dt)
            max_abs[entry] = max(max_abs[entry], err)
            if entry == "dw" and not torch.equal(got, kernel()):
                raise AssertionError(f"rbgp4_sddmm {m} x {k} N={n}: a "
                                     f"rerun changed the bits")
            del got
        log("times-fm", f"{m} x {k} N={n} bf16 held against the plain "
                        f"versions, max|diff|/max|ref|: "
                        + ", ".join(f"{e} {v:.2e}" for e, v in rel.items()))
        c = lambda i: i % copies
        outs = {"fwd": torch.empty((m, n), dtype=dt, device="cuda"),
                "dx": torch.empty((k, n), dtype=dt, device="cuda"),
                "dw": torch.empty((m, nnz), dtype=dt, device="cuda")}
        t = dict(
            fwd_fma=time_cuda(lambda i: _fm_body("fma", tables, xs[c(i)], w,
                                                 outs["fwd"])),
            dx_fma=time_cuda(lambda i: _fm_body("fma", tt.tables, gs[c(i)],
                                                wt, outs["dx"])),
            dw_fma=time_cuda(lambda i: _fm_sddmm_body(
                "fma", tables, gs[c(i)], xs[c(i)], outs["dw"])),
            fwd=time_cuda(lambda i: rbgp4mm(tables, xs[c(i)], w)),
            fwd_plain=time_cuda(lambda i: rbgp4mm_reference(tables, xs[c(i)],
                                                            w)),
            fwd_lib=time_cuda(lambda i: wd @ xs[c(i)]),
            dx=time_cuda(lambda i: rbgp4mm(tt.tables, gs[c(i)], wt)),
            dx_plain=time_cuda(lambda i: rbgp4mm_reference(tt.tables,
                                                           gs[c(i)], wt)),
            dx_lib=time_cuda(lambda i: wd.T @ gs[c(i)]),
            dw=time_cuda(lambda i: rbgp4_sddmm(tables, gs[c(i)], xs[c(i)])),
            dw_plain=time_cuda(lambda i: rbgp4_sddmm_reference(
                tables, gs[c(i)], xs[c(i)])),
            dw_lib=time_cuda(lambda i: gs[c(i)] @ xs[c(i)].T),
        )
        chunks = d.d_o * d.d_i
        bounds = dict(
            fwd=bound_ms(n, m, k, nnz, chunks, d.group_rows, 2),
            dx=bound_ms(n, d_t.m, d_t.k, d_t.data_cols, d_t.d_o * d_t.d_i,
                        d_t.group_rows, 2),
            dw=sddmm_bound_ms(n, m, k, nnz, chunks, d.group_rows, 2))
        for role, (b, by) in bounds.items():
            rows[((m, k, n), role)] = dict(ms=t[role],
                                           fma_ms=t[f"{role}_fma"],
                                           plain_ms=t[f"{role}_plain"],
                                           library_ms=t[f"{role}_lib"],
                                           bound_ms=b, bound_by=by)
            log("times-fm", f"{role:3s} {m} x {k} N={n} bf16: kernel "
                            f"{t[role]:.4f} ms ({bodies[role]} body), FMA "
                            f"body {t[role + '_fma']:.4f} ms, plain "
                            f"{t[role + '_plain']:.4f} ms, torch.matmul "
                            f"dense {t[role + '_lib']:.4f} ms, bound "
                            f"{b * 1e3:.2f} us ({by})")
        del xs, gs, w, wt, wd, outs
        torch.cuda.empty_cache()
    return rows


def phase_fm_body_sweep(layouts) -> dict:
    """Both bodies of ``rbgp4mm`` (O on the forward tables, dI on the
    transposed ones) and of ``rbgp4_sddmm`` at VGG19's eight distinct
    layer shapes, bf16, on the same operands: the FMA body and the
    tensor-core body at each tile of ``FM_MMA_TILES`` (O, dI) and each
    block of ``FM_SDDMM_TILES`` (dW, with ``fm_sddmm_plan``'s slices for
    it), each result first held against the plain version, then timed
    (CUDA events, operands cycled past the L2).  Returns {((m, k, n),
    role): {candidate: ms}}, role "fwd", "dx" or "dw", candidate "fma" or
    the tile: the measurement ``fm_path``, ``fm_mma_tile`` and
    ``fm_sddmm_tile`` are set from."""
    from repro_torch.kernels import (FM_MMA_TILES, FM_SDDMM_TILES,
                                     KernelTables, TransposeTables, fm_path,
                                     fm_mma_tile, fm_sddmm_path,
                                     fm_sddmm_plan, fm_sddmm_tile,
                                     rbgp4_sddmm_reference,
                                     rbgp4mm_reference)
    from repro_torch.kernels.rbgp4mm import (_fm_body, _fm_sddmm_body,
                                             _sm_count)

    g = torch.Generator(device="cuda").manual_seed(15)
    dt = torch.bfloat16
    sms = _sm_count("cuda")
    out = {}
    picked = {"fwd": [0.0, 0.0], "dx": [0.0, 0.0], "dw": [0.0, 0.0]}
    for m, k, n in dict.fromkeys(VGG19_SDMM):
        lay = layouts[(m, k)]
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        d, d_t = tables.dims, tt.tables.dims
        copies = max(1, -(-2 * L2_BYTES // ((k + m) * n * 2)))
        xs = torch.randn((copies, k, n), device="cuda", generator=g).to(dt)
        gs = torch.randn((copies, m, n), device="cuda", generator=g).to(dt)
        w = torch.randn(lay.data_shape, device="cuda", generator=g).to(dt)
        wt = tt.values(w)
        c = lambda i: i % copies

        roles = {
            "fwd": (torch.empty((m, n), dtype=dt, device="cuda"),
                    lambda: rbgp4mm_reference(tables, xs[0], w),
                    [("fma", None)] + [("mma", t) for t in FM_MMA_TILES],
                    lambda p, t, o, i: _fm_body(p, tables, xs[c(i)], w, o,
                                                tile=t),
                    (fm_path(d, n, dt), fm_mma_tile(tables, n))),
            "dx": (torch.empty((k, n), dtype=dt, device="cuda"),
                   lambda: rbgp4mm_reference(tt.tables, gs[0], wt),
                   [("fma", None)] + [("mma", t) for t in FM_MMA_TILES],
                   lambda p, t, o, i: _fm_body(p, tt.tables, gs[c(i)], wt,
                                               o, tile=t),
                   (fm_path(d_t, n, dt), fm_mma_tile(tt.tables, n))),
            "dw": (torch.empty(lay.data_shape, dtype=dt, device="cuda"),
                   lambda: rbgp4_sddmm_reference(tables, gs[0], xs[0]),
                   [("fma", None)] + [("mma", b) for b in FM_SDDMM_TILES],
                   lambda p, t, o, i: _fm_sddmm_body(
                       p, tables, gs[c(i)], xs[c(i)], o,
                       plan=fm_sddmm_plan(d, n, sms, t) if t else None),
                   (fm_sddmm_path(d, n, dt), fm_sddmm_tile(d, n))),
        }
        for role, (o, ref, cands, run, choice) in roles.items():
            want = ref()
            ms = {}
            for path, tile in cands:
                run(path, tile, o, 0)
                torch.cuda.synchronize()
                name = "fma" if path == "fma" else str(tile)
                agree(f"fm sweep {role} {m} x {k} N={n} [{name}]", o, want,
                      dt)
                ms[name] = time_cuda(lambda i: run(path, tile, o, i))
            del want
            best = min(ms, key=ms.get)
            chosen = "fma" if choice[0] == "fma" else str(choice[1])
            picked[role][0] += VGG19_SDMM.count((m, k, n)) * ms[chosen]
            picked[role][1] += VGG19_SDMM.count((m, k, n)) * ms[best]
            out[((m, k, n), role)] = ms
            log("fm-sweep", f"{role:3s} {m} x {k} N={n} bf16: "
                            + ", ".join(f"{a} {b:.4f}" for a, b in ms.items())
                            + f" ms; fastest {best}, the wrappers take "
                              f"{chosen}")
        del xs, gs, w, wt
        torch.cuda.empty_cache()
    for role, (chosen, best) in picked.items():
        log("fm-sweep", f"{role:3s} a VGG19 pass: the wrappers' choice "
                        f"{chosen:.4f} ms, the fastest swept {best:.4f} ms")
    return out


def vgg19_weights(layouts, batch: int, dt, device, seed: int):
    """Per layer: a ``CompactWeight`` over its layout's cached ``RBGP4Op``
    (the tables, and the transposed ones built at the first dI) and the
    input I (k, res^2 * batch), drawn on the CPU, so that every device
    gets the same numbers."""
    from repro_torch.kernels import get_op
    from repro_torch.sparsity import CompactWeight

    gen = torch.Generator().manual_seed(seed)
    out = []
    for m, k, n in VGG19_SDMM:
        lay = layouts[(m, k)]
        op = get_op(lay, device)
        w = (torch.randn(lay.data_shape, generator=gen)
             * (2.0 / lay.spec.nnz_per_row) ** 0.5)
        x = torch.randn((k, n * batch // 256), generator=gen)
        cw = CompactWeight(w_data=w.to(device, dt).requires_grad_(),
                           tables=op.tables, tables_t=op.transpose_tables)
        out.append((cw, x.to(device, dt).requires_grad_()))
    return out


def vgg19_pass(layers, cots=None):
    """The 15 layers' O through ``sparse_matmul``; with ``cots`` also the
    backward (dW and dI of every layer)."""
    from repro_torch.sparsity import sparse_matmul

    outs = [sparse_matmul(cw, x) for cw, x in layers]
    if cots is not None:
        torch.autograd.backward(outs, cots)
    return outs


def profile_vgg19_pass(layers, cots) -> dict:
    """One forward + backward pass under torch.profiler (the window opens
    with ``PROFILE_PAD`` spin kernels, which count in no time): the pass's
    own fenced wall ms, the card's busy ms, every kernel's time summed,
    and its split between the
    feature-major kernels (``rbgp4mm*``: O and dI; ``rbgp4_sddmm*``: dW and
    its slice sum) and the rest (the transposed values' gather, casts,
    autograd's own kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_PAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vgg19_pass(layers, cots)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    for cw, x in layers:
        cw.w_data.grad = x.grad = None
    ms = {"rbgp4mm": 0.0, "rbgp4_sddmm": 0.0, "other": 0.0}
    n_kernels = 0
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or "spin_kernel" in e.name):
            continue
        key = ("rbgp4_sddmm" if "rbgp4_sddmm" in e.name else
               "rbgp4mm" if "rbgp4mm" in e.name else "other")
        ms[key] += e.time_range.elapsed_us() * 1e-3
        n_kernels += 1
    if not n_kernels:
        raise AssertionError("the profiler recorded no kernel on the card")
    return dict(busy_ms=sum(ms.values()), wall_ms=wall_ms, kernel_ms=ms,
                kernels=n_kernels)


def phase_sdmm_vgg19(layouts, n_pass: int = 3) -> dict:
    """The main path of the feature-major slice: one pass of VGG19-CIFAR's
    15 sparse layers at batch 256, bf16, through ``sparse_matmul`` with
    autograd (dW and dI); every pass launches ``rbgp4mm`` 15 times on
    forward tables and 15 on transposed ones, ``rbgp4_sddmm`` 15 times,
    and nothing else.  Fenced ms of the forward and of forward + backward,
    median of ``n_pass`` passes after a warm-up pass; peak memory."""
    layers = vgg19_weights(layouts, 256, torch.bfloat16, "cuda", seed=11)
    gen = torch.Generator(device="cuda").manual_seed(12)
    cots = [torch.randn((cw.w_data.shape[0], x.shape[1]), device="cuda",
                        generator=gen).to(torch.bfloat16)
            for cw, x in layers]
    want = launches_of(fm_forward=15, fm_dx=15, fm_dw=15)
    vgg19_pass(layers, cots)  # warm-up: builds the transposed tables
    for cw, x in layers:
        cw.w_data.grad = x.grad = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    from repro_torch.kernels import rbgp4_sddmm, rbgp4mm

    fwd_ms, step_ms = [], []
    # the tensor-core launches by role: the forward pass launches only O,
    # the backward dI (rbgp4mm's counter again) and dW
    mma = {"fm_forward": 0, "fm_dx": 0, "fm_dw": 0}
    want_mma = {"fm_forward": 15, "fm_dx": 15, "fm_dw": 15}
    for _ in range(n_pass):
        before = launch_counts()
        fm0, dw0 = rbgp4mm.launches_mma, rbgp4_sddmm.launches_mma
        t0 = time.perf_counter()
        outs = vgg19_pass(layers)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fm1 = rbgp4mm.launches_mma
        torch.autograd.backward(outs, cots)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if counts_since(before) != want:
            raise AssertionError(f"a VGG19 pass launched "
                                 f"{counts_since(before)}, want {want}")
        got = {"fm_forward": fm1 - fm0, "fm_dx": rbgp4mm.launches_mma - fm1,
               "fm_dw": rbgp4_sddmm.launches_mma - dw0}
        if got != want_mma:
            raise AssertionError(f"a VGG19 pass launched {got} on the "
                                 f"tensor-core bodies, want {want_mma}")
        for role, v in got.items():
            mma[role] += v
        fwd_ms.append(1e3 * (t1 - t0))
        step_ms.append(1e3 * (t2 - t0))
        for (m, _, n), o, (cw, x) in zip(VGG19_SDMM, outs, layers):
            if tuple(o.shape) != (m, n) or not bool(torch.isfinite(o).all()):
                raise AssertionError(f"layer {m} x {n}: bad output")
            for grad, ref in ((cw.w_data.grad, cw.w_data), (x.grad, x)):
                if grad is None or grad.shape != ref.shape or not bool(
                        torch.isfinite(grad).all()):
                    raise AssertionError(f"layer {m}: bad gradient")
            cw.w_data.grad = x.grad = None
        del outs
    counts = launch_counts()
    prof = profile_vgg19_pass(layers, cots)
    res = dict(
        layers=len(VGG19_SDMM), batch=256,
        fwd_ms=statistics.median(fwd_ms), fwd_bwd_ms=statistics.median(
            step_ms), fwd_ms_all=fwd_ms, fwd_bwd_ms_all=step_ms,
        launches=counts, launches_per_pass=want, mma_launches=mma,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        card_busy_ms=prof["busy_ms"], card_kernel_ms=prof["kernel_ms"],
        profiled_pass_ms=prof["wall_ms"],
        card_idle_share=1.0 - prof["busy_ms"] / prof["wall_ms"],
        card_idle_share_of_median=1.0 - prof["busy_ms"] / statistics.median(
            step_ms))
    log("sdmm-vgg19", f"VGG19-CIFAR, 15 sparse layers at batch 256, bf16, "
                      f"through sparse_matmul: forward {res['fwd_ms']:.3f} "
                      f"ms, forward + backward {res['fwd_bwd_ms']:.3f} ms "
                      f"(median of {n_pass} passes; "
                      + ", ".join(f"{a:.3f}/{b:.3f}"
                                  for a, b in zip(fwd_ms, step_ms))
                      + f"); peak memory {res['peak_mem_gb']:.2f} GB")
    log("sdmm-vgg19", f"launches per pass, counted at each launch: "
                      + ", ".join(f"{k_} {v}" for k_, v in want.items() if v)
                      + f"; in {n_pass} passes {counts}; on the "
                        f"tensor-core bodies (rbgp4mm_mma_kernel, "
                        f"rbgp4_sddmm_mma_kernel) " + ", ".join(
                            f"{k_} {v}" for k_, v in mma.items()))
    log("sdmm-vgg19", f"one profiled forward + backward pass: card busy "
                      f"{prof['busy_ms']:.3f} ms ("
                      + ", ".join(f"{k_} {v:.3f}"
                                  for k_, v in prof["kernel_ms"].items())
                      + f" ms; {prof['kernels']} kernels) in a fenced "
                        f"{prof['wall_ms']:.3f} ms, so the card is idle "
                        f"{100 * res['card_idle_share']:.1f}% of that pass "
                        f"(and {100 * res['card_idle_share_of_median']:.1f}%"
                        f" of the median unprofiled pass, {n_pass} others)")
    print("sdmm-vgg19 " + json.dumps(res), flush=True)
    del layers, cots
    free_card()
    return res


def phase_parity_fm(layouts, batch: int = 2) -> None:
    """The same 15 layers in float32 at batch 2 (N = res^2 * 2): O, dW and
    dI through ``sparse_matmul`` on the card (the kernels) and on the CPU
    (the plain versions) from the same inputs, within 1e-5 * max|ref|."""
    from repro_torch.kernels import rbgp4_sddmm, rbgp4mm

    runs = {}
    mma0 = (rbgp4mm.launches_mma, rbgp4_sddmm.launches_mma)
    for device in ("cuda", "cpu"):
        layers = vgg19_weights(layouts, batch, torch.float32, device,
                               seed=13)
        gen = torch.Generator().manual_seed(14)
        cots = [torch.randn((cw.w_data.shape[0], x.shape[1]),
                            generator=gen).to(device) for cw, x in layers]
        before = launch_counts()
        outs = vgg19_pass(layers, cots)
        runs[device] = ([o.detach().cpu() for o in outs],
                        [cw.w_data.grad.cpu() for cw, _ in layers],
                        [x.grad.cpu() for _, x in layers],
                        counts_since(before))
    want = launches_of(fm_forward=15, fm_dx=15, fm_dw=15)
    if runs["cuda"][3] != want or any(runs["cpu"][3].values()):
        raise AssertionError(f"launches: card {runs['cuda'][3]}, CPU "
                             f"{runs['cpu'][3]}")
    if (rbgp4mm.launches_mma, rbgp4_sddmm.launches_mma) != mma0:
        raise AssertionError("float32 launches took a tensor-core body")
    worst = {}
    for i, name in enumerate(("O", "dW", "dI")):
        for (m, k, _), a, b in zip(VGG19_SDMM, runs["cuda"][i],
                                   runs["cpu"][i]):
            _, rel = agree(f"parity-fm {name} {m} x {k}", a, b,
                           torch.float32)
            worst[name] = max(worst.get(name, 0.0), rel)
    log("parity-fm", f"15 layers at batch {batch}, float32, card against "
                     f"CPU: max|diff|/max|ref| "
                     + ", ".join(f"{k_} {v:.2e}" for k_, v in worst.items())
                     + f" (tolerance {TOL[torch.float32]:.0e}); card "
                       f"launches {runs['cuda'][3]}")
    free_card()


# -- the int8 (scales=) paths: weight-only PTQ storage ------------------------

def int8_values(shape, G: int, C: int, g) -> tuple:
    """(q int8, scales f32) of random values, quantized per (G, C) leaf
    block as the port's ``quantize_weights`` does."""
    from repro_torch.sparsity.quant import quantize_block_values

    return quantize_block_values(
        torch.randn(shape, device="cuda", generator=g), G, C)


def phase_check_q(layouts, experts, chains) -> dict:
    """The int8 paths against their plain versions on the same int8
    values and scales (tolerance as phase 2), each rerun bit-equal:
    ``rbgp4mm_rhs`` at tinyllama's four layouts and the small layout of
    the CPU tests at N in {1, 8, 512}; ``rbgp4mm_rhs_stacked`` at
    qwen2-moe's two expert layouts, 60 experts, at the rows an expert that
    serve-q-moe gives it (8 at decode; 128, 256 and 512 at a prefill);
    ``chainmm_rhs`` at the hierarchical-block chain's four layouts and the
    two chains of the CPU tests (G = C = 1 among them) at N in {1, 8,
    512}; f32 and bf16.  Max abs diff per kernel."""
    from repro_torch.core import RBGP4Layout, RBGP4Spec
    from repro_torch.kernels import (KernelTables, chain_tables, chainmm_rhs,
                                     chainmm_rhs_reference, rbgp4mm_rhs,
                                     rbgp4mm_rhs_reference,
                                     rbgp4mm_rhs_stacked,
                                     rbgp4mm_rhs_stacked_reference)
    from repro_torch.sparsity import leaf_block_dims

    g = torch.Generator(device="cuda").manual_seed(21)
    max_abs = {"rbgp4": 0.0, "stacked": 0.0, "chain": 0.0}
    n_cases = 0
    rbgp4 = dict(layouts, small=RBGP4Layout(RBGP4Spec(**SMALL_RBGP4)))
    families = (
        ("rbgp4", rbgp4, (1, 8, 512), 1,
         lambda lay: KernelTables.build(lay, "cuda"), rbgp4mm_rhs,
         rbgp4mm_rhs_reference),
        ("stacked", experts, (MOE_ROWS["decode"], *SERVE_PROMPT_LENS),
         MOE_EXPERTS, lambda lay: KernelTables.build(lay, "cuda"),
         rbgp4mm_rhs_stacked, rbgp4mm_rhs_stacked_reference),
        ("chain", chains, (1, 8, 512), 1,
         lambda lay: chain_tables(lay, "cuda"), chainmm_rhs,
         chainmm_rhs_reference),
    )
    for family, lays, rows, e, tables_of, kernel, plain in families:
        for key, lay in lays.items():
            tables = tables_of(lay)
            G, C = leaf_block_dims(lay)
            lead = (e,) if family == "stacked" else ()
            q, sc = int8_values((*lead, *lay.data_shape), G, C, g)
            for dt in (torch.float32, torch.bfloat16):
                worst = 0.0
                for n in rows:
                    x = torch.randn((*lead, n, lay.k), device="cuda",
                                    generator=g).to(dt)
                    run = lambda: kernel(tables, x, q, scales=sc)
                    y = launched(kernel, run, "launches_q")
                    what = f"int8 {family} {key} N={n}"
                    err, rel = agree(what, y, plain(tables, x, q, scales=sc),
                                     dt)
                    if not torch.equal(y, run()):
                        raise AssertionError(f"{what} {dt}: a rerun gave "
                                             f"other bits")
                    max_abs[family] = max(max_abs[family], err)
                    worst = max(worst, rel)
                    n_cases += 1
                log("check-q", f"{family:7s} {key:8s} G = {G}, C = {C} "
                               f"{str(dt):15s} max|diff|/max|ref| = "
                               f"{worst:.2e} (N in {rows}), reruns "
                               f"bit-equal")
            del q, sc
            torch.cuda.empty_cache()
    log("check-q", f"{n_cases} int8 cases agree with their plain versions "
                   f"on the same int8 values; max abs diff "
                   + ", ".join(f"{k} {v:.3e}" for k, v in max_abs.items()))
    return max_abs


def phase_times_q(layouts, experts, chains, n: int = 8) -> dict:
    """The int8 paths at a decode step's N rows, bf16 X and Y, one row per
    (family, layout): the int8 kernel, the same layout's bf16 kernel on
    the dequantized values, the int8 plain version, one PyTorch call on
    the dequantized dense weights (``F.linear``; ``torch.bmm`` for the 60
    experts), and the bound with 1-byte values and their scales; operands
    cycled through more than the L2 cache as phase 3."""
    from repro_torch.kernels import (KernelTables, chain_tables, chainmm_rhs,
                                     chainmm_rhs_reference, rbgp4mm_rhs,
                                     rbgp4mm_rhs_reference,
                                     rbgp4mm_rhs_stacked,
                                     rbgp4mm_rhs_stacked_reference)
    from repro_torch.kernels.chainmm import chain_unpack_dense
    from repro_torch.kernels.ref import dequant_leaf_blocks, unpack_dense
    from repro_torch.sparsity import leaf_block_dims

    g = torch.Generator(device="cuda").manual_seed(22)
    dt = torch.bfloat16
    rows = {}
    chain_full = {key: chains[key] for key in FULL_WIDTH}
    families = (
        ("rbgp4", layouts, 1, lambda lay: KernelTables.build(lay, "cuda"),
         rbgp4mm_rhs, rbgp4mm_rhs_reference, unpack_dense),
        ("stacked", experts, MOE_EXPERTS,
         lambda lay: KernelTables.build(lay, "cuda"), rbgp4mm_rhs_stacked,
         rbgp4mm_rhs_stacked_reference, unpack_dense),
        ("chain", chain_full, 1, lambda lay: chain_tables(lay, "cuda"),
         chainmm_rhs, chainmm_rhs_reference, chain_unpack_dense),
    )
    for family, lays, e, tables_of, kernel, plain, unpack in families:
        for key, lay in lays.items():
            tables = tables_of(lay)
            G, C = leaf_block_dims(lay)
            m, k = lay.m, lay.k
            nnz = lay.data_shape[1]
            chunks = nnz // C
            lead = (e,) if family == "stacked" else ()
            copies = max(2, -(-2 * L2_BYTES // (e * m * nnz)))
            q, sc = int8_values((copies, *lead, m, nnz), G, C, g)
            w16 = dequant_leaf_blocks(q, sc, G, C).to(dt)
            dense_copies = max(2, -(-2 * L2_BYTES // (e * m * k * 2)))
            wd = torch.stack([unpack(lay, w16[i % copies])
                              for i in range(dense_copies)])
            x = torch.randn((*lead, n, k), device="cuda", generator=g).to(dt)
            c = lambda i: i % copies
            d = lambda i: i % dense_copies
            t_q = time_cuda(lambda i: kernel(tables, x, q[c(i)],
                                             scales=sc[c(i)]))
            t_bf16 = time_cuda(lambda i: kernel(tables, x, w16[c(i)]))
            t_plain = time_cuda(lambda i: plain(tables, x, q[c(i)],
                                                scales=sc[c(i)]))
            if family == "stacked":
                t_lib = time_cuda(lambda i: torch.bmm(
                    x, wd[d(i)].transpose(1, 2)))
            else:
                t_lib = time_cuda(lambda i: F.linear(x, wd[d(i)]))
            b, by = bound_ms(n, m, k, nnz, chunks, G, 2, e=e, int8=True)
            b16, _ = bound_ms(n, m, k, nnz, chunks, G, 2, e=e)
            rows[(family, key)] = dict(ms=t_q, plain_ms=t_plain,
                                       library_ms=t_lib, bound_ms=b,
                                       bound_by=by, bf16_ms=t_bf16,
                                       bf16_bound_ms=b16)
            log("times-q", f"{family:7s} {key:8s} N={n} (G = {G}, C = {C}"
                           f"{f', {e} experts' if e > 1 else ''}): int8 "
                           f"kernel {t_q:.4f} ms, bf16 kernel "
                           f"{t_bf16:.4f} ms, int8 plain {t_plain:.4f} ms, "
                           f"{'torch.bmm' if e > 1 else 'F.linear'} dense "
                           f"{t_lib:.4f} ms, bound {b * 1e3:.2f} us ({by}; "
                           f"bf16 {b16 * 1e3:.2f} us)")
            del q, sc, w16, wd, x
            torch.cuda.empty_cache()
    return rows


def per_layer_q(rows: dict, family: str, projections: dict) -> dict:
    """One decoder layer's projections of an int8 path: ``per_layer``'s
    sums, with the bf16 kernel's time and bound beside them."""
    sub = {(key, 8): row for (fam, key), row in rows.items()
           if fam == family}
    agg = per_layer(sub, 8, projections)
    for f in ("bf16_ms", "bf16_bound_ms"):
        agg[f] = sum(count * sub[(key, 8)][f]
                     for key, count in projections.items())
    return agg


# -- the paper's vision models: VGG19-CIFAR and WRN-40-4 trained end to end ---

def conv_layers(arch: str) -> list:
    """(m, k, n) of each sparse conv of ``arch`` at 0.75 (``min_dim`` 64), in
    network order, at batch 256: the token-major product Y (n, m) = P (n,
    k) . W_s^T of the unfolded patches P, n = H' * W' * 256."""
    return list(VGG19_SDMM if arch == "vgg19-cifar" else WRN40_4_CONV)


def conv_shapes() -> list:
    """The distinct (m, k, n) of both models' sparse convs at batch 256."""
    return sorted(set(conv_layers("vgg19-cifar"))
                  | set(conv_layers("wrn40-4-cifar")))


def conv_layouts() -> dict:
    from repro_torch.core import RBGP4Layout, design_rbgp4

    return {(m, k): RBGP4Layout(design_rbgp4(m, k, 0.75, seed=0))
            for m, k, _ in conv_shapes()}


def vision_model(arch: str, pattern: str, device, dtype,
                 min_dim: int = 64, seed: int = 0, plan=None):
    """The full-width ``arch`` (``get_config``) with ``pattern`` at 0.75
    (``backend="auto"``: compact storage for RBGP4, masked storage for the
    unstructured and block patterns), the paper's keep-dense rule, weights
    drawn from ``seed`` on ``device``; or, given ``plan``, under that
    plan (``VisionConfig.plan``, every rule its own)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.vision import VGG19, WideResNet
    from repro_torch.sparsity import SparsityConfig

    sp = (SparsityConfig() if pattern == "dense" else
          SparsityConfig(pattern=pattern, sparsity=VISION_SPARSITY,
                         backend="auto", min_dim=min_dim))
    if plan is not None:
        sp = SparsityConfig()
    cfg = dataclasses.replace(get_config(arch), sparsity=sp, plan=plan)
    cls = VGG19 if arch == "vgg19-cifar" else WideResNet
    gen = torch.Generator(device=device).manual_seed(seed)
    return cls(cfg, device=device, dtype=dtype, generator=gen)


def sparse_convs(model) -> list:
    """The model's sparse convs (compact or masked storage), in order."""
    from repro_torch.models.vision import SparseConv2D

    return [mod for mod in model.modules()
            if isinstance(mod, SparseConv2D) and mod.mode != "dense"]


def conv_geometry(model, batch: int) -> list:
    """(m, k, n) of each sparse conv of ``model`` at ``batch`` images, from
    the output sizes of one image's forward."""
    tokens = {}
    convs = sparse_convs(model)
    hooks = [mod.register_forward_hook(
        lambda mod, args, out: tokens.__setitem__(
            mod.name, out.shape[1] * out.shape[2])) for mod in convs]
    with torch.no_grad():
        model(torch.zeros((1, 32, 32, 3), device=model.device))
    for h in hooks:
        h.remove()
    return [(mod.out_features, mod.in_features, tokens[mod.name] * batch)
            for mod in convs]


def conv_mma_counts(model, batch: int,
                    dt: torch.dtype = torch.bfloat16) -> dict:
    """The tensor-core launches one training step of ``model`` at ``batch``
    images must make, by role, as ``rhs_path`` and ``sddmm_path`` name
    them: the forward on each compact conv's layout, dX on its transposed
    layout and dW."""
    from repro_torch.kernels import rhs_path, sddmm_path

    out = {"forward": 0, "dx": 0, "dw": 0}
    convs = [mod for mod in sparse_convs(model) if mod.mode == "compact"]
    for mod, (_, _, n) in zip(convs, conv_geometry(model, batch)):
        dims, dims_t = mod.tables.dims, mod.transpose_tables().tables.dims
        out["forward"] += rhs_path(dims, n, dt) == "mma"
        out["dx"] += rhs_path(dims_t, n, dt) == "mma"
        out["dw"] += sddmm_path(dims, n, dt) == "mma"
    return out


def phase_check_conv(layouts) -> dict:
    """``rbgp4mm_rhs`` (forward, and dX on ``TransposeTables``) and
    ``rbgp4_sddmm_rhs`` against their plain versions at the two models'
    conv layouts, f32 and bf16, at N in ``CONV_CHECK_N`` and each layer's
    own N at batch 256: each launch moves ``launches_mma`` exactly when the
    path function names the tensor-core body, and each dW is rerun
    bit-equal."""
    from repro_torch.kernels import (KernelTables, TransposeTables,
                                     rbgp4_sddmm_rhs,
                                     rbgp4_sddmm_rhs_reference, rbgp4mm_rhs,
                                     rbgp4mm_rhs_reference, rhs_path,
                                     sddmm_path)

    g = torch.Generator(device="cuda").manual_seed(21)
    max_abs = {"forward": 0.0, "dx": 0.0, "dw": 0.0}
    n_cases = 0
    for m, k, n_own in conv_shapes():
        lay = layouts[(m, k)]
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        dims, dims_t = tables.dims, tt.tables.dims
        for dt in (torch.float32, torch.bfloat16):
            rnd = lambda *s: torch.randn(*s, device="cuda",
                                         generator=g).to(dt)
            worst = {"forward": 0.0, "dx": 0.0, "dw": 0.0}
            bodies = []
            w = rnd(*lay.data_shape)
            wt = tt.values(w)
            for n in CONV_CHECK_N + (n_own,):
                x, gy = rnd(n, k), rnd(n, m)
                paths = (rhs_path(dims, n, dt), rhs_path(dims_t, n, dt),
                         sddmm_path(dims, n, dt))
                cases = (
                    ("forward", rbgp4mm_rhs, "launches", paths[0],
                     lambda: rbgp4mm_rhs(tables, x, w),
                     lambda: rbgp4mm_rhs_reference(tables, x, w)),
                    ("dx", rbgp4mm_rhs, "launches_dx", paths[1],
                     lambda: rbgp4mm_rhs(tt.tables, gy, wt),
                     lambda: rbgp4mm_rhs_reference(tt.tables, gy, wt)),
                    ("dw", rbgp4_sddmm_rhs, "launches", paths[2],
                     lambda: rbgp4_sddmm_rhs(tables, gy, x),
                     lambda: rbgp4_sddmm_rhs_reference(tables, gy, x)))
                for role, fn, attr, path, run, plain in cases:
                    mma0 = fn.launches_mma
                    got = launched(fn, run, attr)
                    if fn.launches_mma - mma0 != (path == "mma"):
                        raise AssertionError(
                            f"conv {m} x {k} N={n} {dt} {role}: "
                            f"launches_mma moved by "
                            f"{fn.launches_mma - mma0}, the path is {path}")
                    err, rel = agree(f"conv {m} x {k} N={n} {role}", got,
                                     plain(), dt)
                    if role == "dw" and not torch.equal(got, run()):
                        raise AssertionError(f"conv dW {m} x {k} N={n} {dt}:"
                                             f" a rerun changed the bits")
                    max_abs[role] = max(max_abs[role], err)
                    worst[role] = max(worst[role], rel)
                    n_cases += 1
                bodies.append(f"N={n} " + "/".join(paths))
            log("check-conv", f"{m:3d} x {k:4d} (G {dims.group_rows}, C "
                              f"{dims.chunk_cols}; transposed G "
                              f"{dims_t.group_rows}, C {dims_t.chunk_cols}) "
                              f"{str(dt):14s} max|diff|/max|ref|: "
                              + ", ".join(f"{r} {v:.2e}"
                                          for r, v in worst.items())
                              + "; bodies fwd/dX/dW: " + "; ".join(bodies))
        del tables, tt
        torch.cuda.empty_cache()
    log("check-conv", f"{n_cases} cases agree at {len(conv_shapes())} conv "
                      f"layouts, every dW bit-equal on a rerun, every "
                      f"launches_mma as the path functions name it; max abs "
                      f"diff " + ", ".join(f"{k_} {v:.3e}"
                                           for k_, v in max_abs.items()))
    return max_abs


def _library_sparse(w_masked: torch.Tensor, fmt: str, xt: torch.Tensor):
    """torch's own sparse product W (m, k) @ xt (k, n) in ``fmt`` ('csr' or
    'bsr' with 4 x 4 blocks): (timed call, dtype it ran in).  Where torch
    refuses bf16 for it, float32 (said so by the dtype); (None, None) where
    it refuses both (logged)."""
    for dt in (torch.bfloat16, torch.float32):
        w = w_masked.to(dt)
        sw = w.to_sparse_csr() if fmt == "csr" else w.to_sparse_bsr((4, 4))
        x = xt.to(dt)
        try:
            torch.sparse.mm(sw, x)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:
            log("times-conv", f"torch {fmt} product refuses {dt}: "
                              f"{str(e).splitlines()[0][:120]}")
            continue
        return (lambda i: torch.sparse.mm(sw, x)), str(dt).split(".")[-1]
    return None, None


def phase_times_conv(layouts) -> dict:
    """The conv layouts at their batch-256 N, bf16: the forward, dX and dW
    kernels, their FMA bodies on the same operands, their plain versions,
    one dense product each on the unpacked weights (``F.linear``, ``g @
    W``, ``g^T @ x``), the bound; for the forward also the masked
    product (``sparse_linear`` on a ``MaskedWeight``, mask multiply
    included) and torch's own CSR and BSR products (``torch.sparse.mm``)
    on the unstructured and block (4 x 4) masks of the same shape at 0.75,
    feature-major (W @ X^T): library calls, which the port never makes."""
    from repro_torch.kernels import (KernelTables, TransposeTables,
                                     rbgp4_sddmm_rhs,
                                     rbgp4_sddmm_rhs_reference, rbgp4mm_rhs,
                                     rbgp4mm_rhs_reference, rhs_path,
                                     sddmm_path)
    from repro_torch.kernels.ref import unpack_dense
    from repro_torch.sparsity import (MaskedWeight, SparsityConfig,
                                      make_pattern, sparse_linear)

    g = torch.Generator(device="cuda").manual_seed(22)
    dt = torch.bfloat16
    rows = {}
    timed = lambda fn: time_cuda(fn, n_iter=10, n_warm=2)
    for m, k, n in conv_shapes():
        lay = layouts[(m, k)]
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        dims, dims_t = tables.dims, tt.tables.dims
        nnz = lay.data_shape[1]
        copies = max(1, -(-2 * L2_BYTES // ((n * m + n * k) * 2)))
        xs = torch.randn((copies, n, k), device="cuda", generator=g).to(dt)
        gs = torch.randn((copies, n, m), device="cuda", generator=g).to(dt)
        c = lambda i: i % copies
        w = torch.randn((m, nnz), device="cuda", generator=g).to(dt)
        wt, wd = tt.values(w), unpack_dense(lay, w)
        fma_rhs, fma_sddmm = body_launchers(tables, "fma")
        fma_rhs_t, _ = body_launchers(tt.tables, "fma")
        y_out = torch.empty((n, m), dtype=dt, device="cuda")
        dx_out = torch.empty((n, k), dtype=dt, device="cuda")
        dw_out = torch.empty((m, nnz), dtype=dt, device="cuda")
        masks = {p: torch.as_tensor(make_pattern(SparsityConfig(
            pattern=p, sparsity=VISION_SPARSITY, min_dim=64), m, k).mask(),
            device="cuda") for p in ("unstructured", "block")}
        w_full = torch.randn((m, k), device="cuda", generator=g).to(dt)
        masked = MaskedWeight(w=w_full, mask=masks["unstructured"])
        xt = xs[0].T.contiguous()
        csr, csr_dt = _library_sparse(w_full * masks["unstructured"], "csr",
                                      xt)
        bsr, bsr_dt = _library_sparse(w_full * masks["block"], "bsr", xt)
        t = dict(
            fwd=timed(lambda i: rbgp4mm_rhs(tables, xs[c(i)], w)),
            fwd_fma=timed(lambda i: fma_rhs(xs[c(i)], w, y_out)),
            fwd_plain=timed(lambda i: rbgp4mm_rhs_reference(
                tables, xs[c(i)], w)),
            fwd_lib=timed(lambda i: F.linear(xs[c(i)], wd)),
            fwd_masked=timed(lambda i: sparse_linear(masked, xs[c(i)])),
            fwd_csr=timed(csr) if csr else None,
            fwd_bsr=timed(bsr) if bsr else None,
            dx=timed(lambda i: rbgp4mm_rhs(tt.tables, gs[c(i)], wt)),
            dx_fma=timed(lambda i: fma_rhs_t(gs[c(i)], wt, dx_out)),
            dx_plain=timed(lambda i: rbgp4mm_rhs_reference(
                tt.tables, gs[c(i)], wt)),
            dx_lib=timed(lambda i: gs[c(i)] @ wd),
            dw=timed(lambda i: rbgp4_sddmm_rhs(tables, gs[c(i)], xs[c(i)])),
            dw_fma=timed(lambda i: fma_sddmm(gs[c(i)], xs[c(i)], dw_out)),
            dw_plain=timed(lambda i: rbgp4_sddmm_rhs_reference(
                tables, gs[c(i)], xs[c(i)])),
            dw_lib=timed(lambda i: gs[c(i)].T @ xs[c(i)]),
        )
        key = (m, k, n)
        b, by = bound_ms(n, m, k, nnz, dims.d_o * dims.d_i,
                         dims.group_rows, 2)
        rows[(key, "fwd")] = dict(
            ms=t["fwd"], plain_ms=t["fwd_plain"], library_ms=t["fwd_lib"],
            bound_ms=b, bound_by=by, fma_ms=t["fwd_fma"],
            masked_ms=t["fwd_masked"], csr_ms=t["fwd_csr"],
            csr_dtype=csr_dt, bsr_ms=t["fwd_bsr"], bsr_dtype=bsr_dt)
        b, by = bound_ms(n, dims_t.m, dims_t.k, dims_t.data_cols,
                         dims_t.d_o * dims_t.d_i, dims_t.group_rows, 2)
        rows[(key, "dx")] = dict(ms=t["dx"], plain_ms=t["dx_plain"],
                                 library_ms=t["dx_lib"], bound_ms=b,
                                 bound_by=by, fma_ms=t["dx_fma"])
        b, by = sddmm_bound_ms(n, m, k, nnz, dims.d_o * dims.d_i,
                               dims.group_rows, 2)
        rows[(key, "dw")] = dict(ms=t["dw"], plain_ms=t["dw_plain"],
                                 library_ms=t["dw_lib"], bound_ms=b,
                                 bound_by=by, fma_ms=t["dw_fma"])
        paths = (rhs_path(dims, n, dt), rhs_path(dims_t, n, dt),
                 sddmm_path(dims, n, dt))
        log("times-conv", f"{m:3d} x {k:4d} N={n:<6d} bf16 (G "
                          f"{dims.group_rows}, C {dims.chunk_cols}; dX G "
                          f"{dims_t.group_rows}, "
                          f"C {dims_t.chunk_cols}) bodies "
                          f"{'/'.join(paths)}: forward kernel "
                          f"{t['fwd']:.4f} ms, FMA body {t['fwd_fma']:.4f}, "
                          f"plain {t['fwd_plain']:.4f}, F.linear dense "
                          f"{t['fwd_lib']:.4f}, masked {t['fwd_masked']:.4f},"
                          f" torch CSR ({csr_dt}) {t['fwd_csr']}, torch "
                          f"BSR 4x4 ({bsr_dt}) {t['fwd_bsr']}, bound "
                          f"{rows[(key, 'fwd')]['bound_ms']:.4f}; dX kernel "
                          f"{t['dx']:.4f}, FMA {t['dx_fma']:.4f}, g @ W "
                          f"{t['dx_lib']:.4f}, bound "
                          f"{rows[(key, 'dx')]['bound_ms']:.4f}; dW kernel "
                          f"{t['dw']:.4f}, FMA {t['dw_fma']:.4f}, g^T @ x "
                          f"{t['dw_lib']:.4f}, bound "
                          f"{rows[(key, 'dw')]['bound_ms']:.4f}")
        del xs, gs, w, wt, wd, w_full, masked, csr, bsr, tables, tt
        torch.cuda.empty_cache()
    return rows


def vision_train_config(n_steps: int, lr: float = 0.1):
    """The paper's recipe: SGD momentum 0.9, weight decay 1e-4, the step
    schedule (x0.2 at half and three quarters of the run), clip 1.0."""
    from repro_torch.configs import TrainConfig

    return TrainConfig(optimizer="sgdm", lr=lr, momentum=0.9,
                       weight_decay=1e-4, schedule="step",
                       lr_step_epochs=(n_steps // 2, 3 * n_steps // 4),
                       lr_step_gamma=0.2, grad_clip=1.0)


def phase_train_vision(arch: str, pattern: str, n_steps: int = 6,
                       batch: int = VISION_BATCH, plan=None,
                       phase: str = "train-vision") -> dict:
    """``n_steps`` of ``Trainer.run`` on the full-width ``arch`` with
    ``pattern`` storage (or, given ``plan``, under that plan: its sparse
    convs compact), bf16 compute over f32 master values, on
    ``GaussianClassImages(10, batch, seed=0)``: every step's sparse
    launches, counted at each launch (RBGP4: each sparse conv's forward,
    dX and dW), the tensor-core launches by role equal to what the path
    functions name (``VISION_MMA`` for RBGP4 at 0.75), finite losses and
    gradient norms; the mean of the last ``n_steps - 1`` steps, images/s,
    peak memory, the layout copies a step; then one profiled step (card
    busy and idle share)."""
    from repro_torch.data import GaussianClassImages
    from repro_torch.kernels import rbgp4_sddmm_rhs, rbgp4mm_rhs
    from repro_torch.models.vision import SparseConv2D
    from repro_torch.train import Trainer, classifier_loss

    model = vision_model(arch, pattern, "cuda", torch.bfloat16, plan=plan)
    convs = sparse_convs(model)
    modes = {mod.mode for mod in convs}
    n_sparse = len(convs)
    if pattern == "dense":
        want_modes, want = set(), launches_of()
    else:
        want_modes = {"compact" if pattern in ("rbgp4", "plan")
                      else "masked"}
        if plan is None and n_sparse != VISION_SPARSE[arch]:
            raise AssertionError(f"{arch}: {n_sparse} sparse convs")
        want = (launches_of(forward=n_sparse, dx=n_sparse, dw=n_sparse)
                if pattern in ("rbgp4", "plan") else launches_of())
    if modes != want_modes:
        raise AssertionError(f"{arch} {pattern}: storage {modes}")
    want_mma = {"forward": 0, "dx": 0, "dw": 0}
    if pattern == "plan":
        want_mma = conv_mma_counts(model, batch)
    if pattern == "rbgp4":
        if conv_geometry(model, batch) != conv_layers(arch):
            raise AssertionError(f"{arch}: conv geometry "
                                 f"{conv_geometry(model, batch)}")
        want_mma = conv_mma_counts(model, batch)
        if tuple(want_mma.values()) != VISION_MMA[arch]:
            raise AssertionError(f"{arch}: the path functions name "
                                 f"{want_mma} tensor-core launches a step, "
                                 f"want {VISION_MMA[arch]}")
    trainer = Trainer(model, vision_train_config(n_steps),
                      GaussianClassImages(10, batch, seed=0),
                      checkpoint=False, loss_fn=classifier_loss())
    counts = []
    trainer.hooks.append(lambda step, metrics: counts.append(
        (launch_counts(), rbgp4mm_rhs.launches_mma,
         rbgp4_sddmm_rhs.launches_mma, SparseConv2D.layout_copies)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    copies0 = SparseConv2D.layout_copies
    hist = list(trainer.run(n_steps))
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != {k: v * n_steps for k, v in want.items()}:
        raise AssertionError(f"{launches} launches in {n_steps} steps")
    prev = (dict.fromkeys(COUNTERS, 0), 0, 0, copies0)
    for i, (c, rhs_mma, dw_mma, copies) in enumerate(counts):
        step = {k: c[k] - prev[0][k] for k in COUNTERS}
        mma = (rhs_mma - prev[1], dw_mma - prev[2])
        if step != want or mma != (want_mma["forward"] + want_mma["dx"],
                                   want_mma["dw"]):
            raise AssertionError(f"step {i}: launches {step}, tensor-core "
                                 f"(rbgp4mm_rhs, rbgp4_sddmm_rhs) {mma}; "
                                 f"want {want}, {want_mma}")
        copies_per_step = copies - prev[3]
        prev = (c, rhs_mma, dw_mma, copies)
    # the forward alone: its tensor-core launches are the forward's share
    before = rbgp4mm_rhs.launches_mma
    with torch.no_grad():
        model(torch.as_tensor(GaussianClassImages(10, batch, seed=0)
                              .batch_at(0)["images"], device="cuda"))
    fwd_mma = rbgp4mm_rhs.launches_mma - before
    if fwd_mma != want_mma["forward"]:
        raise AssertionError(f"a forward took {fwd_mma} tensor-core "
                             f"launches, want {want_mma['forward']}")
    for h in hist:
        if not all(np.isfinite(h[k]) for k in ("loss", "grad_norm", "acc")):
            raise AssertionError(f"step {h['step']}: {h}")
    timed = [h["step_time_s"] for h in hist[1:]]
    step_ms = 1e3 * statistics.mean(timed)
    prof = profile_train_step(trainer, phase)
    if prof["kernel_launches"] != want:
        raise AssertionError(f"profiled step launches "
                             f"{prof['kernel_launches']}")
    res = dict(
        arch=arch, storage=pattern, modes=sorted(modes), batch=batch,
        steps=n_steps, losses=[h["loss"] for h in hist],
        grad_norms=[h["grad_norm"] for h in hist],
        step_ms=[1e3 * t for t in timed], mean_step_ms=step_ms,
        images_per_s=batch / (step_ms / 1e3), peak_mem_gb=peak_gb,
        launches=launches, launches_per_step=want,
        mma_per_step=want_mma, layout_copies_per_step=copies_per_step,
        profile=prof, busy_ms=prof["busy_ms"],
        idle_share=1.0 - prof["busy_share"],
        idle_share_unprofiled=1.0 - prof["busy_ms"] / step_ms)
    fmt = lambda xs, f: ", ".join(f"{x:{f}}" for x in xs)
    log(phase, f"{arch} {pattern} ({'/'.join(sorted(modes)) or 'dense'} "
               f"storage), batch {batch}, bf16 over f32 masters: losses "
               f"{fmt(res['losses'], '.4f')}; grad norms "
               f"{fmt(res['grad_norms'], '.3f')}")
    log(phase, f"{arch} {pattern}: last {len(timed)} steps "
               f"{step_ms:.1f} ms/step ({fmt(res['step_ms'], '.1f')}), "
               f"{res['images_per_s']:.0f} images/s; peak memory "
               f"{peak_gb:.2f} GB; {copies_per_step} layout copies a step")
    log(phase, f"{arch} {pattern}: launches per step, counted at each "
               f"launch: rbgp4mm_rhs {want['forward']} forward + "
               f"{want['dx']} dX, rbgp4_sddmm_rhs {want['dw']}; on the "
               f"tensor-core bodies (forward, dX, dW) "
               f"{tuple(want_mma.values())} (a forward alone {fwd_mma})")
    log(phase, f"{arch} {pattern}: profiled step {prof['wall_ms']:.1f} ms "
               f"wall, card busy {prof['busy_ms']:.1f} ms "
               f"({prof['busy_share']:.1%}; idle {res['idle_share']:.1%}; "
               f"idle {res['idle_share_unprofiled']:.1%} of the unprofiled "
               f"step); sparse kernels "
               + ", ".join(f"{k} {prof['kernel_ms'][k]:.1f} ms"
                           for k in ("forward", "dx", "dw")))
    print(f"{phase} " + json.dumps(res), flush=True)
    del trainer, model
    free_card()
    return res


class ConvRecorder:
    """For each sparse conv of a model whose values take gradients: its
    unfolded input (the product's X), X's gradient, the output's gradient
    and the values' gradient of the model's first backward (the layer's own
    dX and dW)."""

    def __init__(self, model):
        self.rec = {}
        self.handles = []
        for mod in sparse_convs(model):
            r = self.rec[mod.name] = {}
            value = mod.w if mod.mode == "masked" else mod.w_data
            self.handles.append(value.register_hook(
                lambda gr, r=r: self._keep(r, "dw", gr)))
            self.handles.append(mod.register_forward_hook(
                lambda mod, args, out, r=r: self._out(r, out)))
            patches = mod.patches

            def rec_patches(x, patches=patches, r=r):
                p = patches(x)
                if "x" not in r and p.requires_grad:
                    p.retain_grad()
                    r["x_t"] = p
                    r["x"] = p.detach().cpu()
                return p

            mod.patches = rec_patches
            self.handles.append(mod)

    @staticmethod
    def _keep(r, key, grad) -> None:
        """Keep the first gradient under ``key``; a tensor hook returning
        None leaves the gradient as it is."""
        if key not in r:
            r[key] = grad.detach().to("cpu", copy=True)

    def _out(self, r, out):
        if "g" not in r and out.requires_grad:
            out.register_hook(lambda g: self._keep(r, "g", g))

    def remove(self):
        for h in self.handles:
            if isinstance(h, torch.nn.Module):
                del h.patches
            else:
                h.remove()


def phase_parity_vision(pattern: str, batch: int = 8) -> None:
    """float32, VGG19-CIFAR at full width: the same weights and batches
    train 2 steps on the card (the kernels; for masked storage the dense
    products) and on the CPU (the plain versions); the card's first step
    launches each sparse conv's forward, dX and dW (RBGP4) and the CPU
    nothing.  Held: the first forward's logits within 1e-4 * max|ref|,
    each step's loss within 1e-4 relative, and every sparse conv's dW and
    dX of the card's first backward against the CPU's product on the
    card's own unfolded input and output gradient, within 1e-4 *
    max|ref|.  (The model-level gradients are not held: the two devices
    sum in different orders, so a pre-ReLU value near 0 can pass the ReLU
    on one device only, and that one kink moves a 2 x 2 layer's
    batch-norm bias gradient by percents; the CPU tests measured the drift
    between the port and the reference at up to 1e-4 at VGG19's last
    convs.)"""
    from repro_torch.data import GaussianClassImages
    from repro_torch.train import Trainer, classifier_loss

    phase = "parity-vision"
    arch = "vgg19-cifar"
    gpu = vision_model(arch, pattern, "cuda", torch.float32)
    cpu = vision_model(arch, pattern, "cpu", torch.float32)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    data = GaussianClassImages(10, batch, seed=0)
    images = data.batch_at(0)["images"]
    with torch.no_grad():
        logits = [m(torch.as_tensor(images, device=m.device)).cpu()
                  for m in (gpu, cpu)]
    err = float((logits[0] - logits[1]).abs().max())
    scale = float(logits[1].abs().max())
    if not err <= 1e-4 * scale:
        raise AssertionError(f"{phase} {pattern}: logits max|diff| {err} > "
                             f"1e-4 * {scale}")
    runs = {}
    recorder = None
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        reset_launch_counts()
        tr = Trainer(model, vision_train_config(2, lr=0.05), data,
                     checkpoint=False, loss_fn=classifier_loss())
        if name == "cuda":
            recorder = ConvRecorder(model)
        else:
            # the CPU's products on the card's recorded tensors, from the
            # initial values (before the CPU model trains)
            layer_worst = layer_parity(cpu, recorder.rec, phase, pattern)
        hist = tr.run(2)
        if name == "cuda":
            recorder.remove()
        runs[name] = ([h["loss"] for h in hist], launch_counts())
    n = VISION_SPARSE[arch]
    want = (launches_of(forward=2 * n, dx=2 * n, dw=2 * n)
            if pattern == "rbgp4" else launches_of())
    if runs["cuda"][1] != want or any(runs["cpu"][1].values()):
        raise AssertionError(f"launches: card {runs['cuda'][1]}, cpu "
                             f"{runs['cpu'][1]}, want {want}")
    worst_loss = max(abs(a - b) / abs(b)
                     for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    if not worst_loss <= 1e-4:
        raise AssertionError(f"{phase} {pattern}: losses {runs['cuda'][0]} "
                             f"(card) vs {runs['cpu'][0]} (cpu)")
    log(phase, f"{arch} {pattern}, float32, batch {batch}: logits "
               f"max|diff|/max|ref| {err / scale:.2e}; losses card "
               f"{runs['cuda'][0]} vs cpu {runs['cpu'][0]} (worst "
               f"{worst_loss:.2e} relative); {n} sparse convs' dW and dX "
               f"on the card's own tensors: worst max|diff|/max|ref| "
               + ", ".join(f"{k} {v:.2e}" for k, v in layer_worst.items())
               + f"; card launches {runs['cuda'][1]}")
    del gpu, cpu, recorder
    free_card()


def layer_parity(cpu, rec: dict, phase: str, pattern: str) -> dict:
    """Each sparse conv of the CPU model against the card's recorded first
    backward: dW and dX of ``sparse_linear`` on the card's unfolded input
    and output gradient, within 1e-4 * max|ref|."""
    from repro_torch.sparsity import sparse_linear

    worst = {"dw": 0.0, "dx": 0.0}
    for mod in sparse_convs(cpu):
        r = rec[mod.name]
        value = mod.w if mod.mode == "masked" else mod.w_data
        w0 = value.detach().clone().requires_grad_()
        weight = mod.weight()
        if mod.mode == "masked":
            weight.w = w0
        else:
            weight.w_data = w0
        x = r["x"].clone().requires_grad_()
        sparse_linear(weight, x).backward(r["g"])
        for role, got, ref in (("dw", r["dw"], w0.grad),
                               ("dx", r["x_t"].grad.cpu(), x.grad)):
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            if not (scale > 0 and err <= 1e-4 * scale):
                raise AssertionError(f"{phase} {pattern} {mod.name} {role}: "
                                     f"max|diff| {err} > 1e-4 * {scale}")
            worst[role] = max(worst[role], err / scale)
    return worst


def phase_kd_protocol(n_steps: int = 80, batch: int = 64) -> dict:
    """``examples/cifar_vgg_rbgp4.py``'s protocol at WRN-40-4's full width,
    batch ``batch``, bf16 compute: a dense teacher, then an unstructured
    (masked) and an RBGP4 (compact) student at 0.75 (``min_dim`` 32, as the
    example) with KD alpha 0.5 from the teacher, ``n_steps`` each on
    ``GaussianClassImages(10, batch, seed=3)``, the paper's recipe at lr
    0.05; each model's accuracy on 512 held-out images (the same
    prototypes, unseen noise).  The data is synthetic, so only finite
    losses are held."""
    from repro_torch.data import GaussianClassImages
    from repro_torch.train import Trainer, classifier_loss

    phase = "kd-protocol"
    arch = "wrn40-4-cifar"
    held_out = GaussianClassImages(10, 512, seed=3).batch_at(10_000)
    labels = torch.as_tensor(held_out["labels"], device="cuda").long()
    res, teacher = {}, None
    for pattern in ("dense", "unstructured", "rbgp4"):
        t0 = time.perf_counter()
        model = vision_model(arch, pattern, "cuda", torch.bfloat16,
                             min_dim=32)
        loss_fn = (classifier_loss() if teacher is None
                   else classifier_loss(teacher, alpha=0.5))
        tr = Trainer(model, vision_train_config(n_steps, lr=0.05),
                     GaussianClassImages(10, batch, seed=3),
                     checkpoint=False, loss_fn=loss_fn)
        hist = tr.run(n_steps)
        losses = [h["loss"] for h in hist]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{phase} {pattern}: losses {losses}")
        with torch.no_grad():
            logits = model(torch.as_tensor(held_out["images"],
                                           device="cuda"))
        acc = float((logits.argmax(-1) == labels).float().mean())
        res[pattern] = dict(acc=acc, first_loss=losses[0],
                            last_loss=losses[-1],
                            seconds=time.perf_counter() - t0)
        role = " student, KD alpha 0.5" if teacher else " teacher"
        log(phase, f"{arch} {pattern}{role}: "
                   f"{n_steps} steps of {batch}, loss {losses[0]:.4f} -> "
                   f"{losses[-1]:.4f}; held-out accuracy {acc:.3f} "
                   f"({res[pattern]['seconds']:.1f} s)")
        if teacher is None:
            teacher = model
        else:
            del model
        del tr
    print(f"{phase} " + json.dumps(res), flush=True)
    del teacher
    free_card()
    return res


# -- the plan compiler: budget-solved plans, certified, trained and served ----

def budget_plan(arch: str):
    """(config, shape table, plan) of ``arch`` at full width: the plan
    compiler's ``solve_budget`` at ``PLAN_TARGET_DENSITY`` and
    ``PLAN_MIN_DIM`` over the shapes ``model_matmul_shapes`` records."""
    from repro_torch.configs import get_config
    from repro_torch.sparsity import model_matmul_shapes, solve_budget

    cfg = get_config(arch)
    shapes = model_matmul_shapes(cfg)
    plan = solve_budget(shapes, target_density=PLAN_TARGET_DENSITY,
                        min_dim=PLAN_MIN_DIM)
    return cfg, shapes, plan


def plan_train_tokens(arch: str, shapes: dict) -> dict:
    """path -> the tokens its product runs at a training step of the
    phases: 8 x 512 (tinyllama, phase 6), 4 x 512 (qwen2-moe, phase 10;
    its experts ``MOE_ROWS['train']`` rows an expert), each conv's own N
    at batch 256 (the vision models, ``conv_layers``)."""
    if arch == "tinyllama-1.1b":
        return dict.fromkeys(shapes, 8 * 512)
    if arch == "qwen2-moe-a2.7b":
        return {p: MOE_ROWS["train"] if ".experts." in p else 4 * 512
                for p in shapes}
    convs = [p for p in shapes
             if p not in ("stem", "conv0", "fc") and not p.endswith(".proj")]
    layers = conv_layers(arch)
    if [shapes[p][:2] for p in convs] != [(m, k) for m, k, _ in layers]:
        raise AssertionError(f"{arch}: recorded convs {convs} are not "
                             f"conv_layers' {layers}")
    return {p: n for p, (_, _, n) in zip(convs, layers)}


def plan_layouts(arch: str, shapes: dict, plan) -> list:
    """The distinct sparse layouts of ``plan`` over ``shapes``, each a
    dict: (m, k, sparsity), the layout, the paths on it, whether they are
    stacked experts, the largest training N (rows an expert) among them,
    the kernel dims of the layout and of its transpose
    (``transpose_layout()``), and the bodies ``rhs_path`` / ``sddmm_path``
    name for its forward, dX and dW in bf16 at that N."""
    from repro_torch.kernels import KernelDims, rhs_path, sddmm_path

    tokens = plan_train_tokens(arch, shapes)
    out = {}
    for path, (m, k, _) in shapes.items():
        inst = plan.pattern_for(path, m, k)
        if inst.layout is None:
            continue
        e = out.setdefault((m, k, inst.sparsity), dict(
            arch=arch, m=m, k=k, sparsity=inst.sparsity,
            layout=inst.layout, paths=[], n=0,
            stacked=".experts." in path))
        e["paths"].append(path)
        e["n"] = max(e["n"], tokens[path])
    bf16 = torch.bfloat16
    for e in out.values():
        d = KernelDims.from_layout(e["layout"])
        d_t = KernelDims.from_layout(e["layout"].transpose_layout())
        e.update(dims=d, dims_t=d_t, bodies=(
            rhs_path(d, e["n"], bf16), rhs_path(d_t, e["n"], bf16),
            sddmm_path(d, e["n"], bf16)))
    return list(out.values())


def held_layouts() -> set:
    """(m, k, sparsity) of the layouts phases 2 (tinyllama's four and
    qwen2-moe's two expert layouts) and 28 (the conv layouts) hold."""
    return {(m, k, 0.75) for m, k in (list(FULL_WIDTH.values())
                                      + list(MOE_WIDTH.values()))} | {
        (m, k, 0.75) for m, k, _ in conv_shapes()}


def fma_layouts(plans: dict) -> list:
    """(arch, m, k, sparsity, role, G, C) of every plan layout whose
    forward, dX or dW takes an FMA body at the training N."""
    out = []
    for arch, p in plans.items():
        for e in p["layouts"]:
            for role, body, d in zip(("forward", "dX", "dW"), e["bodies"],
                                     (e["dims"], e["dims_t"], e["dims"])):
                if body == "fma":
                    out.append((arch, e["m"], e["k"], e["sparsity"], role,
                                d.group_rows, d.chunk_cols))
    return out


def phase_plan() -> dict:
    """Solve and certify the budget plans of ``PLAN_ARCHS`` at full width:
    the fingerprints, the rules, each sparse layout's (m, k, sparsity, G,
    C, d_o, d_i) and the bodies of its forward, dX and dW at the training
    N; fails unless ``certify`` finds every proper factor within its
    bound."""
    from repro_torch.sparsity import certify

    plans = {}
    for arch in PLAN_ARCHS:
        t0 = time.perf_counter()
        cfg, shapes, plan = budget_plan(arch)
        t_solve = time.perf_counter() - t0
        report = certify(plan, shapes)
        s = report["summary"]
        if not s["all_ok"]:
            bad = [(p, f["factor"]) for p, e in report["layers"].items()
                   for f in e["factors"] if not f["within_bound"]]
            raise AssertionError(f"{arch}: factors over their bound {bad}")
        layouts = plan_layouts(arch, shapes, plan)
        log("plan", f"{arch}: {len(shapes)} projection paths, plan "
                    f"{plan.fingerprint()} ({len(plan.rules)} rules), "
                    f"density {s['density']:.6f}; certify: "
                    f"{s['n_factors']} factors, {s['n_proper_ramanujan']} "
                    f"proper Ramanujan, {s['n_within_bound']} within bound; "
                    f"solved in {t_solve:.2f}s, certified in "
                    f"{time.perf_counter() - t0 - t_solve:.2f}s")
        for r in plan.rules:
            n_paths = r.match.count("|") + 1 if r.match != ".*" else "rest"
            log("plan", f"  [{n_paths:>4}] sp={r.spec.sparsity:<7.4f} "
                        f"pattern={r.spec.pattern:<6} {r.note}")
        for e in layouts:
            d, d_t = e["dims"], e["dims_t"]
            log("plan", f"  {e['m']} x {e['k']} at {e['sparsity']} "
                        f"({len(e['paths'])} paths"
                        f"{', stacked experts' if e['stacked'] else ''}): "
                        f"G {d.group_rows}, C {d.chunk_cols}, d_o {d.d_o}, "
                        f"d_i {d.d_i}; transposed G {d_t.group_rows}, C "
                        f"{d_t.chunk_cols}; bodies at N={e['n']} "
                        f"forward/dX/dW: {'/'.join(e['bodies'])}")
        plans[arch] = dict(cfg=cfg, shapes=shapes, plan=plan, report=report,
                           layouts=layouts)
    fma = fma_layouts(plans)
    log("plan", f"plan layouts on an FMA body at the training N: "
                + ("; ".join(f"{a} {m} x {k} at {sp} {role} (G {g}, C {c})"
                             for a, m, k, sp, role, g, c in fma) or "none"))
    print("plan " + json.dumps({
        arch: dict(fingerprint=p["plan"].fingerprint(),
                   summary=p["report"]["summary"],
                   layouts=[dict(m=e["m"], k=e["k"], sparsity=e["sparsity"],
                                 G=e["dims"].group_rows,
                                 C=e["dims"].chunk_cols, d_o=e["dims"].d_o,
                                 d_i=e["dims"].d_i, n=e["n"],
                                 paths=len(e["paths"]),
                                 stacked=e["stacked"], bodies=e["bodies"])
                            for e in p["layouts"]])
        for arch, p in plans.items()}), flush=True)
    return plans


def phase_check_plan(plans: dict) -> tuple[dict, dict]:
    """At every layout of the budget plans that phases 2 and 28 do not
    hold: ``rbgp4mm_rhs`` (forward, and dX on ``TransposeTables``) and
    ``rbgp4_sddmm_rhs``, or for stacked experts (60 of them)
    ``rbgp4mm_rhs_stacked`` and ``rbgp4_sddmm_rhs_stacked``, against their
    plain versions at phase 2's tolerances, f32 and bf16, at N in
    ``PLAN_CHECK_N`` (rows an expert: ``PLAN_EXPERT_ROWS``); each launch
    moves ``launches_mma`` exactly when the path function names the
    tensor-core body, each dW reruns bit-equal.  Then, in bf16 at the
    layout's training N, each of the three timed on its body, beside its
    FMA body, its plain version, one PyTorch product on the unpacked
    weights and the bound.  Returns (max abs diff by role, timed rows)."""
    from repro_torch.kernels import (KernelTables, TransposeTables,
                                     rbgp4_sddmm_rhs,
                                     rbgp4_sddmm_rhs_reference,
                                     rbgp4_sddmm_rhs_stacked,
                                     rbgp4_sddmm_rhs_stacked_reference,
                                     rbgp4mm_rhs, rbgp4mm_rhs_reference,
                                     rbgp4mm_rhs_stacked,
                                     rbgp4mm_rhs_stacked_reference, rhs_path,
                                     sddmm_path)

    g = torch.Generator(device="cuda").manual_seed(33)
    held = held_layouts()
    todo = [e for p in plans.values() for e in p["layouts"]
            if (e["m"], e["k"], e["sparsity"]) not in held]
    max_abs = dict.fromkeys(("forward", "dx", "dw", "stacked_forward",
                             "stacked_dx", "stacked_dw"), 0.0)
    rows = {}
    n_cases = 0
    for e in todo:
        lay, m, k = e["layout"], e["m"], e["k"]
        stacked = e["stacked"]
        lead = (MOE_EXPERTS,) if stacked else ()
        tables = KernelTables.build(lay, "cuda")
        tt = TransposeTables.build(lay, "cuda")
        d, d_t = tables.dims, tt.tables.dims
        fwd, dw_fn = ((rbgp4mm_rhs_stacked, rbgp4_sddmm_rhs_stacked)
                      if stacked else (rbgp4mm_rhs, rbgp4_sddmm_rhs))
        fwd_ref, dw_ref = ((rbgp4mm_rhs_stacked_reference,
                            rbgp4_sddmm_rhs_stacked_reference) if stacked
                           else (rbgp4mm_rhs_reference,
                                 rbgp4_sddmm_rhs_reference))
        label = (f"{e['arch']} {m} x {k} at {e['sparsity']}"
                 f"{' (60 experts)' if stacked else ''}")
        for dt in (torch.float32, torch.bfloat16):
            rnd = lambda *s: torch.randn(*s, device="cuda",
                                         generator=g).to(dt)
            worst = {"forward": 0.0, "dx": 0.0, "dw": 0.0}
            bodies = []
            w = rnd(*lead, *lay.data_shape)
            wt = tt.values(w)
            for n in (PLAN_EXPERT_ROWS if stacked else PLAN_CHECK_N):
                x, gy = rnd(*lead, n, k), rnd(*lead, n, m)
                paths = (rhs_path(d, n, dt), rhs_path(d_t, n, dt),
                         sddmm_path(d, n, dt))
                cases = (
                    ("forward", fwd, "launches", paths[0],
                     lambda: fwd(tables, x, w),
                     lambda: fwd_ref(tables, x, w)),
                    ("dx", fwd, "launches_dx", paths[1],
                     lambda: fwd(tt.tables, gy, wt),
                     lambda: fwd_ref(tt.tables, gy, wt)),
                    ("dw", dw_fn, "launches", paths[2],
                     lambda: dw_fn(tables, gy, x),
                     lambda: dw_ref(tables, gy, x)))
                for role, fn, attr, path, run, plain in cases:
                    mma0 = fn.launches_mma
                    got = launched(fn, run, attr)
                    if fn.launches_mma - mma0 != (path == "mma"):
                        raise AssertionError(
                            f"{label} N={n} {dt} {role}: launches_mma moved "
                            f"by {fn.launches_mma - mma0}, the path is "
                            f"{path}")
                    err, rel = agree(f"{label} N={n} {role}", got, plain(),
                                     dt)
                    if role == "dw" and not torch.equal(got, run()):
                        raise AssertionError(f"{label} dW N={n} {dt}: a "
                                             f"rerun changed the bits")
                    entry = ("stacked_" if stacked else "") + role
                    max_abs[entry] = max(max_abs[entry], err)
                    worst[role] = max(worst[role], rel)
                    n_cases += 1
                bodies.append(f"N={n} " + "/".join(paths))
                del x, gy
            log("check-plan", f"{label} (G {d.group_rows}, C "
                              f"{d.chunk_cols}; transposed G "
                              f"{d_t.group_rows}, C {d_t.chunk_cols}) "
                              f"{str(dt):14s} max|diff|/max|ref|: "
                              + ", ".join(f"{r} {v:.2e}"
                                          for r, v in worst.items())
                              + "; bodies fwd/dX/dW: " + "; ".join(bodies))
            del w, wt
        rows.update(time_plan_layout(e, tables, tt, g))
        del tables, tt
        torch.cuda.empty_cache()
    log("check-plan", f"{n_cases} cases agree at {len(todo)} budget-plan "
                      f"layouts no earlier phase holds, every dW bit-equal "
                      f"on a rerun, every launches_mma as the path "
                      f"functions name it; max abs diff "
                      + ", ".join(f"{k_} {v:.3e}"
                                  for k_, v in max_abs.items()))
    return max_abs, rows


def time_plan_layout(e: dict, tables, tt, g) -> dict:
    """check-plan's timings of one layout, bf16 at its training N (rows an
    expert): the forward, dX and dW kernels, their FMA bodies on the same
    operands, their plain versions, one dense PyTorch product each on the
    unpacked weights (``F.linear``, ``g @ W``, ``g^T @ x``; ``torch.bmm``
    for the experts) and the bound."""
    from repro_torch.kernels import (rbgp4_sddmm_rhs,
                                     rbgp4_sddmm_rhs_reference,
                                     rbgp4_sddmm_rhs_stacked,
                                     rbgp4_sddmm_rhs_stacked_reference,
                                     rbgp4mm_rhs, rbgp4mm_rhs_reference,
                                     rbgp4mm_rhs_stacked,
                                     rbgp4mm_rhs_stacked_reference)
    from repro_torch.kernels.ref import unpack_dense

    dt, lay, m, k, n = torch.bfloat16, e["layout"], e["m"], e["k"], e["n"]
    d, d_t = tables.dims, tt.tables.dims
    nnz = lay.data_shape[1]
    stacked = e["stacked"]
    ne = MOE_EXPERTS if stacked else 1
    lead = (ne,) if stacked else ()
    timed = lambda fn: time_cuda(fn, n_iter=10, n_warm=2)
    copies = max(1, -(-2 * L2_BYTES // (ne * (n * m + n * k) * 2)))
    xs = torch.randn((copies, *lead, n, k), device="cuda",
                     generator=g).to(dt)
    gs = torch.randn((copies, *lead, n, m), device="cuda",
                     generator=g).to(dt)
    c = lambda i: i % copies
    w = torch.randn((*lead, m, nnz), device="cuda", generator=g).to(dt)
    wt, wd = tt.values(w), unpack_dense(lay, w)
    y_out = torch.empty((*lead, n, m), dtype=dt, device="cuda")
    dx_out = torch.empty((*lead, n, k), dtype=dt, device="cuda")
    dw_out = torch.empty((*lead, m, nnz), dtype=dt, device="cuda")
    if stacked:
        fwd, dw_fn = rbgp4mm_rhs_stacked, rbgp4_sddmm_rhs_stacked
        fwd_ref, dw_ref = (rbgp4mm_rhs_stacked_reference,
                           rbgp4_sddmm_rhs_stacked_reference)
        fma_rhs = stacked_body_launcher(tables, "fma")
        fma_rhs_t = stacked_body_launcher(tt.tables, "fma")
        fma_sddmm = stacked_sddmm_launcher(tables, "fma")
        lib = (lambda x: torch.bmm(x, wd.transpose(1, 2)),
               lambda gy: torch.bmm(gy, wd),
               lambda gy, x: torch.bmm(gy.transpose(1, 2), x))
    else:
        fwd, dw_fn = rbgp4mm_rhs, rbgp4_sddmm_rhs
        fwd_ref, dw_ref = rbgp4mm_rhs_reference, rbgp4_sddmm_rhs_reference
        fma_rhs, fma_sddmm = body_launchers(tables, "fma")
        fma_rhs_t, _ = body_launchers(tt.tables, "fma")
        lib = (lambda x: F.linear(x, wd), lambda gy: gy @ wd,
               lambda gy, x: gy.T @ x)
    t = dict(
        fwd=timed(lambda i: fwd(tables, xs[c(i)], w)),
        fwd_fma=timed(lambda i: fma_rhs(xs[c(i)], w, y_out)),
        fwd_plain=timed(lambda i: fwd_ref(tables, xs[c(i)], w)),
        fwd_lib=timed(lambda i: lib[0](xs[c(i)])),
        dx=timed(lambda i: fwd(tt.tables, gs[c(i)], wt)),
        dx_fma=timed(lambda i: fma_rhs_t(gs[c(i)], wt, dx_out)),
        dx_plain=timed(lambda i: fwd_ref(tt.tables, gs[c(i)], wt)),
        dx_lib=timed(lambda i: lib[1](gs[c(i)])),
        dw=timed(lambda i: dw_fn(tables, gs[c(i)], xs[c(i)])),
        dw_fma=timed(lambda i: fma_sddmm(gs[c(i)], xs[c(i)], dw_out)),
        dw_plain=timed(lambda i: dw_ref(tables, gs[c(i)], xs[c(i)])),
        dw_lib=timed(lambda i: lib[2](gs[c(i)], xs[c(i)])),
    )
    key = (e["arch"], m, k, e["sparsity"], n)
    rows = {}
    for role, (bnd, by) in (
            ("fwd", bound_ms(n, m, k, nnz, d.d_o * d.d_i, d.group_rows, 2,
                             e=ne)),
            ("dx", bound_ms(n, d_t.m, d_t.k, d_t.data_cols,
                            d_t.d_o * d_t.d_i, d_t.group_rows, 2, e=ne)),
            ("dw", sddmm_bound_ms(n, m, k, nnz, d.d_o * d.d_i,
                                  d.group_rows, 2, e=ne))):
        rows[(key, role)] = dict(
            ms=t[role], fma_ms=t[role + "_fma"], plain_ms=t[role + "_plain"],
            library_ms=t[role + "_lib"], bound_ms=bnd, bound_by=by,
            body=e["bodies"][("fwd", "dx", "dw").index(role)])
    log("times-plan", f"{e['arch']} {m} x {k} at {e['sparsity']} N={n}"
                      f"{' rows an expert, 60 experts' if stacked else ''} "
                      f"bf16, bodies {'/'.join(e['bodies'])}: " + "; ".join(
                          f"{role} {r['ms']:.4f} ms (FMA body "
                          f"{r['fma_ms']:.4f}, plain {r['plain_ms']:.4f}, "
                          f"dense {r['library_ms']:.4f}, bound "
                          f"{r['bound_ms']:.4f} {r['bound_by']})"
                          for (_, role), r in rows.items()))
    del xs, gs, w, wt, wd, y_out, dx_out, dw_out
    return rows


def plan_lm_config(plans: dict, compute_dtype: str = "bfloat16"):
    """Full-width tinyllama under its budget plan."""
    from repro_torch.configs import apply_sparsity

    p = plans["tinyllama-1.1b"]
    return apply_sparsity(p["cfg"], plan=p["plan"]).with_(
        compute_dtype=compute_dtype)


def n_plan_compact(plans: dict, arch: str) -> int:
    """The compact projections (unstacked) of ``arch`` under its plan."""
    return sum(len(e["paths"]) for e in plans[arch]["layouts"]
               if not e["stacked"])


def phase_train_plan(plans: dict, train: dict, vision: dict) -> dict:
    """Full-width tinyllama under its budget plan, 6 steps of 8 x 512
    tokens as phase 6 (every sparse launch counted at the launch, all on
    the tensor cores), and VGG19-CIFAR and WRN-40-4 under theirs, 6 steps
    at batch 256 as phase 30; each beside the uniform-0.75 run of phase 6
    and phase 30's uniform RBGP4 and dense runs."""
    out = {}
    n_c = n_plan_compact(plans, "tinyllama-1.1b")
    out["tinyllama-1.1b"] = res = phase_train(
        plan_lm_config(plans), launches_of(forward=2 * n_c, dx=n_c, dw=n_c),
        n_steps=6, batch=8, seq=512, phase="train-plan")
    log("train-plan", f"tinyllama-1.1b: budget plan "
                      f"{res['mean_step_ms']:.1f} ms/step, "
                      f"{res['tokens_per_s']:.0f} tokens/s, peak "
                      f"{res['peak_mem_gb']:.2f} GB, card busy "
                      f"{res['profile']['busy_ms']:.1f} ms (idle "
                      f"{1 - res['busy_share_unprofiled']:.1%} unprofiled), "
                      f"{n_c} compact projections ({3 * n_c} sparse "
                      f"launches a step, all on the tensor cores); uniform "
                      f"0.75 (phase 6) {train['mean_step_ms']:.1f} ms/step, "
                      f"peak {train['peak_mem_gb']:.2f} GB, busy "
                      f"{train['profile']['busy_ms']:.1f} ms")
    for arch in VISION_ARCHS:
        out[arch] = r = phase_train_vision(arch, "plan",
                                           plan=plans[arch]["plan"],
                                           phase="train-plan")
        n_mma = sum(r["mma_per_step"].values())
        n_all = sum(r["launches_per_step"].values())
        beside = "".join(
            f"; uniform {pat} {vision[(arch, pat)]['mean_step_ms']:.1f} "
            f"ms/step (peak {vision[(arch, pat)]['peak_mem_gb']:.2f} GB, "
            f"busy {vision[(arch, pat)]['busy_ms']:.1f} ms)"
            for pat in ("rbgp4", "dense"))
        log("train-plan", f"{arch}: budget plan {r['mean_step_ms']:.1f} "
                          f"ms/step, {r['images_per_s']:.0f} images/s, peak "
                          f"{r['peak_mem_gb']:.2f} GB, busy "
                          f"{r['busy_ms']:.1f} ms (idle "
                          f"{r['idle_share_unprofiled']:.1%} unprofiled), "
                          f"{n_all} sparse launches a step, {n_mma} on the "
                          f"tensor cores{beside}")
    return out


def table_bytes(obj, seen: set) -> int:
    """Bytes of the card tensors held by a tables object (``KernelTables``,
    its ``RowGroupClasses``, ``TransposeTables``), each counted once
    (``seen`` holds the data pointers already counted)."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        if obj.data_ptr() in seen:
            return 0
        seen.add(obj.data_ptr())
        return obj.numel() * obj.element_size()
    if dataclasses.is_dataclass(obj):
        return sum(table_bytes(getattr(obj, f.name), seen)
                   for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return sum(table_bytes(v, seen) for v in obj.values())
    return 0


def projection_bytes(model) -> dict:
    """What the model's projections hold on the card: ``values`` (compact,
    chain and stacked values, dense and masked projection weights, biases;
    int8 values and their scales) and ``tables`` (kernel index tables,
    forward and any built transposed ones)."""
    from repro_torch.models.moe import StackedExperts
    from repro_torch.sparsity import SparseLinear

    values = tables = 0
    seen: set = set()
    for mod in model.modules():
        if not isinstance(mod, (SparseLinear, StackedExperts)):
            continue
        values += sum(t.numel() * t.element_size()
                      for name, t in mod.state_dict().items()
                      if name.rsplit(".", 1)[-1] not in ("ba_o", "ba_i",
                                                         "mask"))
        tables += table_bytes(getattr(mod, "tables", None), seen)
        tables += table_bytes(getattr(mod, "_tables_t", None), seen)
    return {"values": values, "tables": tables}


def phase_serve_plan(plans: dict, serve: dict) -> dict:
    """Full-width tinyllama under its budget plan through
    ``ContinuousEngine(plan=..., max_live_tokens=PLAN_SERVE_BUDGET)``,
    phase 4's 16 requests: the admission budget the plan's freed weight
    bytes grow it to, held equal to ``plan_aware_live_tokens`` recomputed
    from ``model_matmul_shapes``; the peak live tokens must pass the
    budget alone (the credit admits more); the bytes the storage holds
    beside the bytes credited (reported: the reference's formula defines
    admission); throughput and decode ms/step beside phase 4's."""
    from repro_torch.serve import plan_aware_live_tokens
    from repro_torch.sparsity import model_matmul_shapes

    cfg = plan_lm_config(plans)
    n_c = n_plan_compact(plans, "tinyllama-1.1b")
    res = phase_serve(cfg, launches_of(forward=n_c), phase="serve-plan",
                      engine_kw=dict(plan=cfg.plan,
                                     max_live_tokens=PLAN_SERVE_BUDGET))
    shapes = model_matmul_shapes(cfg)
    want = plan_aware_live_tokens(
        PLAN_SERVE_BUDGET, plan=cfg.plan, shapes=shapes,
        kv_bytes_per_token=res["kv_bytes_per_token"], value_bytes=2)
    # the formula's resident bytes: nnz bf16 values a layer, no tables
    dense = sum(2.0 * m * k * c for m, k, c in shapes.values())
    resident = sum(2.0 * cfg.plan.pattern_for(p, m, k).nnz * c
                   for p, (m, k, c) in shapes.items())
    if res["plan_live_tokens"] != want:
        raise AssertionError(f"engine admits {res['plan_live_tokens']} live "
                             f"tokens, plan_aware_live_tokens gives {want}")
    if res["base_live_tokens"] != PLAN_SERVE_BUDGET \
            or res["admission_tokens"] != min(want, res["pool_tokens"]):
        raise AssertionError(f"admission: {res}")
    if res["peak_live_tokens"] <= PLAN_SERVE_BUDGET:
        raise AssertionError(f"peak live tokens {res['peak_live_tokens']}: "
                             f"the plan's credit admitted no more than B = "
                             f"{PLAN_SERVE_BUDGET}")
    held = res["projection_bytes"]
    res.update(credited_freed_bytes=dense - resident,
               dense_projection_bytes=dense)
    log("serve-plan", f"B = {PLAN_SERVE_BUDGET} live tokens; "
                      f"plan_live_tokens {res['plan_live_tokens']} "
                      f"(plan_aware_live_tokens from model_matmul_shapes: "
                      f"{want}, equal); pool {res['pool_tokens']} tokens, "
                      f"so admission is bounded at "
                      f"{res['admission_tokens']}; "
                      f"{res['kv_bytes_per_token']:.0f} KV bytes a token; "
                      f"peak live tokens {res['peak_live_tokens']}, peak "
                      f"live requests {res['peak_live_requests']}")
    log("serve-plan", f"projection bytes: dense {dense:,.0f}; the plan's "
                      f"formula keeps {resident:,.0f} (values only) and "
                      f"credits {dense - resident:,.0f} freed; the "
                      f"storage holds values {held['values']:,} + index "
                      f"tables {held['tables']:,} = "
                      f"{held['values'] + held['tables']:,}")
    log("serve-plan", f"against phase 4 (uniform 0.75, no budget): "
                      f"{res['tok_per_s']:.1f} vs {serve['tok_per_s']:.1f} "
                      f"tok/s, decode {res['decode_ms_per_step']:.2f} vs "
                      f"{serve['decode_ms_per_step']:.2f} ms/step, prefill "
                      f"{res['prefill_time_s']:.3f} vs "
                      f"{serve['prefill_time_s']:.3f} s, peak "
                      f"{res['peak_mem_gb']:.2f} vs {serve['peak_mem_gb']:.2f} "
                      f"GB")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = phase_build()
    layouts, experts = full_width_layouts(), moe_layouts()
    chains = chain_layouts()
    max_abs = phase_check(layouts)
    max_abs_train = phase_check_train(layouts)
    max_abs_moe = phase_check_moe(experts)
    max_abs_chain = phase_check_chain(chains)
    times = phase_times(layouts)
    times.update(phase_train_times(layouts))
    sweep = phase_body_sweep(layouts)
    times_moe = phase_times_moe(experts)
    tiles = phase_stacked_tiles(experts)
    dw_tiles = phase_stacked_dw_tiles(experts)
    times_chain = phase_times_chain(chains)
    t_fm = time.perf_counter()
    fm = fm_layouts()
    max_abs_fm = phase_check_fm(fm)
    for sp in FM_CHECK_SPARSITIES:  # other G, C and class sizes: other tiles
        phase_check_fm(fm_layouts(sp), dtypes=(torch.bfloat16,),
                       ns=FM_MMA_CHECK_N, label=f"sparsity {sp}: ")
    times_fm = phase_times_fm(fm, max_abs_fm)
    fm_sweep = phase_fm_body_sweep(fm)
    t_fm = time.perf_counter() - t_fm

    # tinyllama: 7 compact projections a layer
    tiny = main_config("bfloat16")
    n_tiny = 7 * tiny.n_layers
    serve = phase_serve(tiny, launches_of(forward=n_tiny))
    phase_parity(main_config("float32"),
                 serve_requests(tiny.vocab_size, 4, seed=1))
    tiny_step = launches_of(forward=2 * n_tiny, dx=n_tiny, dw=n_tiny)
    train = phase_train(tiny, tiny_step, n_steps=6, batch=8, seq=512)
    phase_train_parity(tiny, launches_of(forward=28, dx=14, dw=14))

    # qwen2-moe: attention 4 + shared expert 3 compact projections and 3
    # stacked expert projections a layer
    moe = moe_config("bfloat16")
    n_c, n_s = 7 * moe.n_layers, 3 * moe.n_layers
    serve_moe = phase_serve(moe, launches_of(forward=n_c,
                                             stacked_forward=n_s),
                            phase="serve-moe")
    phase_parity(moe_config("float32"),
                 serve_requests(moe.vocab_size, 16, seed=0),
                 phase="parity-moe")
    moe_step = launches_of(forward=2 * n_c, dx=n_c, dw=n_c,
                           stacked_forward=2 * n_s, stacked_dx=n_s,
                           stacked_dw=n_s)
    train_moe = phase_train(moe, moe_step, n_steps=4, batch=4, seq=512,
                            phase="train-moe")
    phase_train_parity(moe, launches_of(forward=28, dx=14, dw=14,
                                        stacked_forward=12, stacked_dx=6,
                                        stacked_dw=6), phase="parity-moe")

    # tinyllama under the hierarchical-block plan: all 154 projections are
    # chains, and no RBGP4 kernel runs
    chain = chain_config("bfloat16")
    serve_chain = phase_serve(chain, launches_of(chain_forward=n_tiny),
                              phase="serve-chain")
    phase_parity(chain_config("float32"),
                 serve_requests(chain.vocab_size, 4, seed=1),
                 phase="parity-chain")
    train_chain = phase_train(
        chain, launches_of(chain_forward=2 * n_tiny, chain_dx=n_tiny,
                           chain_dw=n_tiny),
        n_steps=6, batch=8, seq=512, phase="train-chain")
    phase_train_parity(chain, launches_of(chain_forward=28, chain_dx=14,
                                          chain_dw=14),
                       phase="train-parity-chain")

    # the paper's feature-major SDMM: VGG19-CIFAR's 15 sparse layers
    t_sdmm = time.perf_counter()
    sdmm = phase_sdmm_vgg19(fm)
    phase_parity_fm(fm)
    t_fm += time.perf_counter() - t_sdmm

    # weight-only int8 (PTQ) serving: the scales= paths of rbgp4mm_rhs,
    # rbgp4mm_rhs_stacked and chainmm_rhs, and no full-precision launch of
    # those kernels
    t_q = time.perf_counter()
    max_abs_q = phase_check_q(layouts, experts, chains)
    times_q = phase_times_q(layouts, experts, chains)
    serve_q = phase_serve(quant_config(tiny),
                          launches_of(forward_q=n_tiny), phase="serve-q",
                          quant=True, beside=serve)
    serve_q_moe = phase_serve(quant_config(moe),
                              launches_of(forward_q=n_c,
                                          stacked_forward_q=n_s),
                              phase="serve-q-moe", quant=True,
                              beside=serve_moe)
    serve_q_chain = phase_serve(quant_config(chain),
                                launches_of(chain_forward_q=n_tiny),
                                phase="serve-q-chain", quant=True,
                                beside=serve_chain)
    phase_parity(quant_config(main_config("float32")),
                 serve_requests(tiny.vocab_size, 4, seed=1),
                 phase="parity-q", quant=True)
    phase_parity(quant_config(moe_config("float32").with_(n_layers=2)),
                 serve_requests(moe.vocab_size, 4, seed=1),
                 phase="parity-q", quant=True)
    phase_parity(quant_config(chain_config("float32").with_(n_layers=2)),
                 serve_requests(chain.vocab_size, 4, seed=1),
                 phase="parity-q", quant=True)
    t_q = time.perf_counter() - t_q

    # the paper's own models, VGG19-CIFAR and WRN-40-4, trained end to end:
    # their sparse convs on rbgp4mm_rhs and rbgp4_sddmm_rhs at the conv
    # layouts, the unstructured and block baselines in masked storage
    t_vis = time.perf_counter()
    convs = conv_layouts()
    max_abs_conv = phase_check_conv(convs)
    times_conv = phase_times_conv(convs)
    vision = {(arch, pattern): phase_train_vision(arch, pattern)
              for arch in VISION_ARCHS for pattern in VISION_PATTERNS}
    for pattern in ("rbgp4", "unstructured"):
        phase_parity_vision(pattern)
    phase_kd_protocol()
    t_vis = time.perf_counter() - t_vis

    # the plan compiler: budget-solved plans of the four models, certified,
    # their new layouts held and timed, trained and served
    t_plan = time.perf_counter()
    plans = phase_plan()
    max_abs_plan, times_plan = phase_check_plan(plans)
    train_plan = phase_train_plan(plans, train, vision)
    serve_plan = phase_serve_plan(plans, serve)
    phase_parity(plan_lm_config(plans, "float32"),
                 serve_requests(tiny.vocab_size, 4, seed=1),
                 phase="parity-plan",
                 engine_kw=dict(plan=plan_lm_config(plans).plan,
                                max_live_tokens=PLAN_SERVE_BUDGET))
    t_plan = time.perf_counter() - t_plan

    per_layout = {f"{key} {kind if isinstance(kind, str) else f'N={kind}'}":
                  row for (key, kind), row in times.items()}
    per_layout.update({f"experts {key} {kind if isinstance(kind, str) else f'N={kind}'}":
                       row for (key, kind), row in times_moe.items()})
    per_layout.update({f"chain {key} {kind if isinstance(kind, str) else f'N={kind}'}":
                       row for (key, kind), row in times_chain.items()})
    per_layout.update({f"fm {m}x{k} N={n} {role}": row
                       for ((m, k, n), role), row in times_fm.items()})
    per_layout.update({f"int8 {family} {key} N=8": row
                       for (family, key), row in times_q.items()})
    per_layout.update({f"layer {kind} N={n} bodies": ms
                       for (kind, n), ms in sweep.items()})
    per_layout.update({f"moe layer {kind} N={n} stacked tiles": ms
                       for (kind, n), ms in tiles.items()})
    per_layout.update({f"experts {key} N={n} stacked dW tile {bc}x{st}": ms
                       for (key, n, (bc, st)), ms in dw_tiles.items()})
    per_layout.update({f"fm {m}x{k} N={n} {role} bodies": ms
                       for ((m, k, n), role), ms in fm_sweep.items()})
    per_layout.update({f"conv {m}x{k} N={n} {role}": row
                       for ((m, k, n), role), row in times_conv.items()})
    per_layout.update({f"plan {arch} {m}x{k} sp={sp} N={n} {role}": row
                       for ((arch, m, k, sp, n), role), row
                       in times_plan.items()})
    print("kernel_times " + json.dumps(per_layout), flush=True)
    src = "src/repro_torch/kernels/csrc/"
    # the forward: one decoder layer's seven projections at decode (N = 8
    # rows, bf16), the shape the serving path launches most; dX and dW:
    # one layer's seven at a training step (N = 4096, bf16).  The stacked
    # kernels: one MoE layer's three expert projections, 60 experts, at
    # decode (8 rows an expert) and at a training step (171 rows an expert)
    fwd = per_layer(times, 8)
    fwd_train = per_layer(times, "fwd")
    dx, dw = per_layer(times, "dx"), per_layer(times, "dw")
    s_fwd = per_layer(times_moe, 8, MOE_LAYER_PROJECTIONS)
    s_fwd_train = per_layer(times_moe, MOE_ROWS["train"],
                            MOE_LAYER_PROJECTIONS)
    s_prefill = per_layer(times_moe, MOE_ROWS["prefill"],
                          MOE_LAYER_PROJECTIONS)
    s_dx = per_layer(times_moe, "dx", MOE_LAYER_PROJECTIONS)
    s_dw = per_layer(times_moe, "dw", MOE_LAYER_PROJECTIONS)
    c_fwd = per_layer(times_chain, 8)
    c_fwd_train = per_layer(times_chain, "fwd")
    c_dx, c_dw = per_layer(times_chain, "dx"), per_layer(times_chain, "dw")
    # one VGG19 pass: the 15 layers' rows, keyed by their (m, k, n)
    vgg19 = collections.Counter(VGG19_SDMM)
    fm_pass = {role: per_layer(times_fm, role, vgg19)
               for role in ("fwd", "dx", "dw")}
    q_fwd = per_layer_q(times_q, "rbgp4", LAYER_PROJECTIONS)
    q_s_fwd = per_layer_q(times_q, "stacked", MOE_LAYER_PROJECTIONS)
    q_c_fwd = per_layer_q(times_q, "chain", LAYER_PROJECTIONS)
    # one VGG19-CIFAR training step's 15 sparse convs at batch 256
    conv_pass = {role: per_layer(times_conv, role, vgg19)
                 for role in ("fwd", "dx", "dw")}
    vision_mma = lambda role: sum(r["mma_per_step"][role] * r["steps"]
                                  for r in vision.values())
    main_runs = (serve, train, serve_moe, train_moe, serve_chain,
                 train_chain, sdmm, serve_q, serve_q_moe,
                 serve_q_chain, serve_plan) + tuple(vision.values()) \
        + tuple(train_plan.values())
    vision_launches = lambda role: sum(r["launches"][role]
                                       for r in vision.values())
    total = lambda role: sum(run["launches"][role] for run in main_runs)
    record = {"kernels": [
        dict(name="rbgp4mm_rhs", route="cuda", source=src + "rbgp4mm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:500",
             launches=total("forward"),
             max_abs_err=max(max_abs, max_abs_train["forward"],
                             max_abs_plan["forward"]),
             **fwd,
             work="forward (serve, and train with its remat recompute; "
                  "tinyllama and qwen2-moe attention and shared expert); "
                  "timed: one tinyllama decoder layer at decode, wq, wk, "
                  "wv, wo, gate, up, down with 8 token rows, bf16"),
        dict(name="rbgp4mm_rhs (training forward, save_preact)",
             route="cuda", source=src + "rbgp4mm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:500",
             launches=train["launches"]["forward"]
             + train_moe["launches"]["forward"],
             max_abs_err=max_abs_train["forward"], **fwd_train,
             work="the training forward and its remat recompute (phases 6 "
                  "and 10, the bf16 tensor-core body); timed: one "
                  "tinyllama decoder layer's seven projections at 4096 "
                  "tokens, bf16, with save_preact and silu (Y and Z "
                  "written); fma_ms: the FMA body on the same operands; "
                  "launches: the forward launches of the tinyllama and "
                  "qwen2-moe training runs"),
        dict(name="rbgp4mm_rhs (dX, transposed layouts)", route="cuda",
             source=src + "rbgp4mm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:500",
             launches=total("dx"),
             max_abs_err=max(max_abs_train["dx"], max_abs_plan["dx"]),
             **dx,
             work="dX = g @ W_s of one tinyllama decoder layer's seven "
                  "projections on their transposed layouts (G 64/128, "
                  "C 16), 4096 tokens, bf16; fma_ms: the FMA body on the "
                  "same operands"),
        dict(name="rbgp4_sddmm_rhs", route="cuda",
             source=src + "rbgp4_sddmm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:674",
             launches=total("dw"),
             max_abs_err=max(max_abs_train["dw"], max_abs_plan["dw"]),
             **dw,
             work="compact dW of one tinyllama decoder layer's seven "
                  "projections, 4096 tokens, bf16; fma_ms: the FMA body on "
                  "the same operands"),
        dict(name="rbgp4mm_rhs_stacked", route="cuda",
             source=src + "rbgp4mm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:773",
             launches=total("stacked_forward"),
             max_abs_err=max(max_abs_moe["forward"],
                             max_abs_plan["stacked_forward"]), **s_fwd,
             work="forward of qwen2-moe's routed experts (serve at full "
                  "capacity, and train with its remat recompute); timed: "
                  "one MoE layer's gate, up and down, 60 experts, 8 rows "
                  "an expert (decode), bf16"),
        dict(name="rbgp4mm_rhs_stacked (training forward, save_preact)",
             route="cuda", source=src + "rbgp4mm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:773",
             launches=train_moe["launches"]["stacked_forward"],
             launches_mma=train_moe["mma_launches"]["stacked_forward"]
             - train_moe["launches"]["stacked_dx"],
             max_abs_err=max_abs_moe["forward"], **s_fwd_train,
             work="the stacked training forward and its remat recompute "
                  "(phase 10, the bf16 tensor-core body "
                  "rbgp4mm_rhs_stacked_mma_kernel); timed: one MoE layer's "
                  "gate, up and down, 60 experts, 171 rows an expert, bf16, "
                  "save_preact and silu (Y and Z written); fma_ms: the FMA "
                  "body on the same operands; mma64_ms: the tensor-core "
                  "body with a 64-token tile"),
        dict(name="rbgp4mm_rhs_stacked (prefill, 512 rows)", route="cuda",
             source=src + "rbgp4mm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:773",
             launches=serve_moe["mma_launches"]["stacked_forward"],
             launches_mma=serve_moe["mma_launches"]["stacked_forward"],
             max_abs_err=max_abs_moe["forward"], **s_prefill,
             work="the stacked forward of a full-capacity prefill (phase "
                  "8's prefill calls, 128-512 rows an expert, the bf16 "
                  "tensor-core body); timed: one MoE layer's gate, up and "
                  "down, 60 experts, 512 rows an expert, bf16; fma_ms: the "
                  "FMA body on the same operands"),
        dict(name="rbgp4mm_rhs_stacked (dX, transposed layouts)",
             route="cuda", source=src + "rbgp4mm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:773",
             launches=total("stacked_dx"),
             launches_mma=train_moe["launches"]["stacked_dx"],
             max_abs_err=max(max_abs_moe["dx"],
                             max_abs_plan["stacked_dx"]), **s_dx,
             work="dX of one MoE layer's gate, up and down on their "
                  "transposed layouts, 60 experts, 171 rows an expert, "
                  "bf16 (the tensor-core body in training); fma_ms: the "
                  "FMA body on the same operands; mma64_ms: the "
                  "tensor-core body with a 64-token tile"),
        dict(name="rbgp4_sddmm_rhs_stacked", route="cuda",
             source=src + "rbgp4_sddmm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:899",
             launches=total("stacked_dw"),
             launches_mma=train_moe["mma_launches"]["stacked_dw"],
             max_abs_err=max(max_abs_moe["dw"],
                             max_abs_plan["stacked_dw"]), **s_dw,
             work="compact dW of one MoE layer's gate, up and down, 60 "
                  "experts, 171 rows an expert, bf16, on the tensor-core "
                  "body (rbgp4_sddmm_rhs_stacked_mma_kernel, every launch "
                  "of phase 10); fma_ms: the FMA body on the same "
                  "operands"),
        dict(name="chainmm_rhs", route="cuda", source=src + "chainmm_rhs.cu",
             replaces="src/repro/kernels/chainmm.py:309",
             launches=total("chain_forward"),
             max_abs_err=max_abs_chain["forward"], **c_fwd,
             work="forward of tinyllama's chain projections under the "
                  "hierarchical-block plan (serve, and train with its "
                  "remat recompute); timed: one decoder layer's seven at "
                  "decode, 8 token rows, bf16 (the FMA body)"),
        dict(name="chainmm_rhs (training forward, N = 4096)", route="cuda",
             source=src + "chainmm_rhs.cu",
             replaces="src/repro/kernels/chainmm.py:309",
             launches=train_chain["launches"]["chain_forward"],
             launches_mma=train_chain["mma_launches"]["chain_forward"]
             - train_chain["launches"]["chain_dx"],
             max_abs_err=max_abs_chain["forward"], **c_fwd_train,
             work="the chain training forward and its remat recompute "
                  "(phase 16, the bf16 tensor-core body over row-group "
                  "classes, chainmm_rhs_mma_kernel); timed: one decoder "
                  "layer's seven at 4096 tokens, bf16; fma_ms: the FMA "
                  "body on the same operands; launches: the forward "
                  "launches of the chain training run"),
        dict(name="chainmm_rhs (dX, transposed layouts)", route="cuda",
             source=src + "chainmm_rhs.cu",
             replaces="src/repro/kernels/chainmm.py:309",
             launches=total("chain_dx"),
             launches_mma=train_chain["launches"]["chain_dx"],
             max_abs_err=max_abs_chain["dx"], **c_dx,
             work="dX = g @ W_s of one chain decoder layer's seven "
                  "projections on their transposed layouts, 4096 tokens, "
                  "bf16, on the tensor-core body over row-group classes; "
                  "fma_ms: the FMA body on the same operands"),
        dict(name="chain_sddmm_rhs", route="cuda",
             source=src + "chain_sddmm_rhs.cu",
             replaces="src/repro/kernels/chainmm.py:427",
             launches=total("chain_dw"),
             launches_mma=train_chain["mma_launches"]["chain_dw"],
             max_abs_err=max_abs_chain["dw"], **c_dw,
             work="chain dW of one decoder layer's seven projections, "
                  "4096 tokens, bf16, on the tensor-core body over "
                  "row-group classes (chain_sddmm_rhs_mma_kernel, every "
                  "launch of phase 16); fma_ms: the FMA body on the same "
                  "operands"),
        dict(name="rbgp4mm", route="cuda", source=src + "rbgp4mm.cu",
             replaces="src/repro/kernels/rbgp4mm.py:245",
             launches=total("fm_forward"),
             launches_mma=sdmm["mma_launches"]["fm_forward"],
             max_abs_err=max_abs_fm["forward"], **fm_pass["fwd"],
             work="O = W_s . I of VGG19-CIFAR's 15 sparse convs, one pass "
                  "at batch 256 (N = res^2 * 256), bf16, on the "
                  "tensor-core body (rbgp4mm_mma_kernel, every launch of "
                  "phase 20); fma_ms: the FMA body on the same operands"),
        dict(name="rbgp4mm (dI, transposed layouts)", route="cuda",
             source=src + "rbgp4mm.cu",
             replaces="src/repro/kernels/rbgp4mm.py:245",
             launches=total("fm_dx"),
             launches_mma=sdmm["mma_launches"]["fm_dx"],
             max_abs_err=max_abs_fm["dx"], **fm_pass["dx"],
             work="dI = W_s^T . dO of VGG19-CIFAR's 15 sparse convs on "
                  "their transposed layouts (G 8-64, C 16), batch 256, "
                  "bf16, on the tensor-core body; fma_ms: the FMA body on "
                  "the same operands"),
        dict(name="rbgp4_sddmm", route="cuda",
             source=src + "rbgp4_sddmm.cu",
             replaces="src/repro/kernels/rbgp4mm.py:336",
             launches=total("fm_dw"),
             launches_mma=sdmm["mma_launches"]["fm_dw"],
             max_abs_err=max_abs_fm["dw"], **fm_pass["dw"],
             work="compact dW = pack(dO . I^T) of VGG19-CIFAR's 15 sparse "
                  "convs, batch 256, bf16, on the tensor-core body "
                  "(rbgp4_sddmm_mma_kernel, every launch of phase 20); "
                  "fma_ms: the FMA body on the same operands"),
        dict(name="rbgp4mm_rhs (int8 scales=)", route="cuda",
             source=src + "rbgp4mm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:500",
             launches=total("forward_q"), max_abs_err=max_abs_q["rbgp4"],
             **q_fwd,
             work="forward of weight-only int8 projections (serve "
                  "tinyllama and qwen2-moe attention and shared expert "
                  "under --quant int8); timed: one tinyllama decoder "
                  "layer's seven at decode, 8 token rows, bf16 X; bf16_ms "
                  "is the bf16 path on the same layer"),
        dict(name="rbgp4mm_rhs_stacked (int8 scales=)", route="cuda",
             source=src + "rbgp4mm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:773",
             launches=total("stacked_forward_q"),
             max_abs_err=max_abs_q["stacked"], **q_s_fwd,
             work="forward of qwen2-moe's int8 routed experts (serve at "
                  "full capacity under --quant int8); timed: one MoE "
                  "layer's gate, up and down, 60 experts, 8 rows an "
                  "expert, bf16 X"),
        dict(name="chainmm_rhs (int8 scales=)", route="cuda",
             source=src + "chainmm_rhs.cu",
             replaces="src/repro/kernels/chainmm.py:309",
             launches=total("chain_forward_q"),
             max_abs_err=max_abs_q["chain"], **q_c_fwd,
             work="forward of tinyllama's int8 chain projections under "
                  "the hierarchical-block plan (serve under --quant "
                  "int8); timed: one decoder layer's seven at decode, 8 "
                  "token rows, bf16 X"),
        dict(name="rbgp4mm_rhs (conv layouts, training forward)",
             route="cuda", source=src + "rbgp4mm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:500",
             launches=vision_launches("forward"),
             launches_mma=vision_mma("forward"),
             max_abs_err=max_abs_conv["forward"], **conv_pass["fwd"],
             work="the forward of VGG19-CIFAR's and WRN-40-4's sparse convs "
                  "on their unfolded patches (train-vision, RBGP4 0.75, "
                  "batch 256, bf16); timed: one VGG19-CIFAR step's 15 at "
                  "N = res^2 x 256; fma_ms: the FMA body on the same "
                  "operands; masked_ms: the masked product (mask multiply "
                  "and F.linear) on the unstructured mask; library_ms: "
                  "F.linear on the unpacked weights"),
        dict(name="rbgp4mm_rhs (conv layouts, dX)", route="cuda",
             source=src + "rbgp4mm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:500",
             launches=vision_launches("dx"), launches_mma=vision_mma("dx"),
             max_abs_err=max_abs_conv["dx"], **conv_pass["dx"],
             work="dX of the vision models' sparse convs on their "
                  "transposed layouts (G 8-64, C 16; 64 x 576 and 128 x "
                  "576 on the FMA body at transposed G 8); timed: one "
                  "VGG19-CIFAR step's 15, bf16; fma_ms: the FMA body on "
                  "the same operands; library_ms: g @ W dense"),
        dict(name="rbgp4_sddmm_rhs (conv layouts)", route="cuda",
             source=src + "rbgp4_sddmm_rhs.cu",
             replaces="src/repro/kernels/rbgp4mm.py:674",
             launches=vision_launches("dw"), launches_mma=vision_mma("dw"),
             max_abs_err=max_abs_conv["dw"], **conv_pass["dw"],
             work="compact dW of the vision models' sparse convs (C 8 "
                  "and 2 on the FMA body); timed: one VGG19-CIFAR step's "
                  "15 at batch 256, bf16; fma_ms: the FMA body on the same "
                  "operands; library_ms: g^T @ x dense"),
    ]}
    for row in record["kernels"]:
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the main "
                                 f"path")
    log("done", f"all phases passed in {time.perf_counter() - t_start:.1f}s "
                f"on {smi}; the four feature-major phases took {t_fm:.1f}s, "
                f"the int8 phases {t_q:.1f}s, the vision phases "
                f"{t_vis:.1f}s, the plan phases {t_plan:.1f}s")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
