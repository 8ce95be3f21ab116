// rbgp4_sddmm_rhs for Hopper (sm_90a): compact dW = pack(g^T . x),
// token-major, with no transposes.
//
// Replaces the Pallas TPU kernel repro/kernels/rbgp4mm.py:rbgp4_sddmm_rhs
// (_sddmm_rhs_kernel, _sddmm_rhs_accumulate): the weight gradient of a
// compact RBGP4 projection, computed only at the mask's non-zeros.
//
// What it computes.  g (N, M) is the cotangent of Y, x (N, K) the
// projection's input, both token-major.  Output row m = rg*G + gi of row
// group rg and compact slot s hold the C values
//   dW[m, s*C + c] = sum_n g[n, m] * x[n, col0[rg, s] + c],   c < C,
// where col0 is the layer's forward table (the same one rbgp4mm_rhs
// reads): col0[rg, s] = adj_o[o, kk]*TK + adj_i[u, ki]*C.  Sums are f32
// whatever the input type; dW is written in g's type.
//
// Two device bodies.  Which one a launch takes is a fixed function of
// dtype and shape, chosen by the caller (kernels/rbgp4mm.py:sddmm_path)
// and passed as `path`, with the tensor-core body's plan (block columns,
// stage tokens, token slices: kernels/rbgp4mm.py:sddmm_mma_plan, a pure
// function of the shapes and the card's SM count); the launcher refuses a
// shape or plan the chosen body cannot take, and nothing falls back from
// one body to the other.
//
// 1. The bf16 tensor-core body, rbgp4_sddmm_rhs_mma_kernel<BC, WARPS>
// and rbgp4_sddmm_rhs_sum_kernel (path 1): bfloat16 at N >= 16 tokens, G
// and C multiples of 16, K a multiple of 8: every dW launch of a training
// step.
//
// What bounds it on an H100.  At a training step of tinyllama-1.1b (4096
// tokens, bf16) a layer's seven dW launches do 2 * 4096 * 11.01e6 = 90.2
// GFLOP, 0.091 ms at the 989 TFLOP/s bf16 dense peak, and read g and x
// once and write dW, about 0.1 ms at 3.35 TB/s.  This design meets L2
// first: a block stages, for its (row group, slot) pair, the N x C slice
// of x at col0[rg, s], which serves only the G rows of the group, so the
// layer reads sum (M/G) * n_chunks * N * C * 2 bytes = 5.64 GB of x from
// L2 (as rbgp4mm_rhs's forward does), plus g, 16 rows a block, 0.89 GB:
// about 1.1 ms at the 5-6 TB/s an H100's L2 gives.  Measured (NVIDIA
// H100 80GB HBM3, 700 W, chip_smoke.py phase 3): 1.06 ms a layer with a
// 2-byte store an output, 0.87 ms since each thread writes 8 outputs of a
// row with one 16-byte store.
//
// What the design does about it.  Tokens are the contraction.  A block
// owns the 16 x BC outputs dW[r0 : r0+16, j0 : j0+BC] (16 rows of a row
// group, BC compact columns of its row: the unstacked plan takes the
// widest of 128, 64, 32, 16 that divides C, so one slot's columns) over
// one token slice.  Each stage brings 16 * WARPS tokens of g[n, r0 :
// r0+16] (two 16-byte chunks a token) and of the block's x columns (each
// 16-byte chunk inside one slot, gathered through col0 once a block) by
// 16-byte cp.async into a ring of 3 stages (rows XOR-swizzled by chunk for
// conflict-free ldmatrix); warp w multiplies the stage's tokens 16w ..
// 16w+15 with mma.sync m16n8k16: ldmatrix.trans turns the token-major g
// tile into the row-major A = g^T fragment and the token-major x tile
// into the col-major B = x fragment, so nothing is transposed in memory.
// Each warp keeps 16 x BC f32 sums (64 registers of sums at BC = 128); at
// the end the warps' sums are added in warp order through the (reused)
// ring, and each thread writes 8 consecutive outputs of a row with one
// 16-byte store.  The unstacked plan takes WARPS = 8 (128-token stages)
// and cuts the token range into n_slices slices of slice_len tokens (a
// multiple of the stage, at least 256) so that the grid reaches two waves
// of blocks on the card's SMs: at N = 4096 only wk/wv is cut (64 pairs: 5
// slices of 896 tokens, 320 blocks); wq/wo, gate/up and down have 512,
// 1408 and 2816 blocks uncut.  With one slice a block writes dW in bf16;
// with more it writes f32 partial sums to a workspace (n_slices, M,
// n_chunks*C) the wrapper allocates, and rbgp4_sddmm_rhs_sum_kernel adds
// the slices in slice order and writes dW.  No atomics: every sum's order
// is fixed by the stage size and the slices, so a rerun gives the same
// bits (the block columns change no sum).  The ragged token edge and the
// columns past the row are zero-filled by the copy itself (src-size 0).
//
// Build (nvcc -Xptxas -v, sm_90a): the unstacked body at BC = 16, 32,
// 64, 128 uses 40, 61, 64 and 118 registers with 8 warps and 40, 48, 64
// and 94 with 4; the stacked one 40, 61, 58 and 124 with 8 warps and 40,
// 56, 64 and 124 with 4 (its 128 x 64 block: four 128-thread blocks an
// SM by registers); no stack, no spills; the slice sums 32.  Dynamic
// shared memory max(3 * 16 * WARPS * (16 + BC) * 2, WARPS * 16 * (BC +
// 8) * 4) bytes, 110,592 at BC = 128 with 8 warps, 55,296 with 4 (each
// launch sets cudaFuncAttributeMaxDynamicSharedMemorySize).  Refused (launcher):
// float32, G or C not a multiple of 16, K not a multiple of 8, g or x not
// 16-byte aligned (the wrapper checks first and raises), block columns
// outside {16, 32, 64, 128}, a stage other than 64 or 128 tokens, a plan
// whose slices do not cover the tokens exactly in whole stages, more than
// 65535 (expert, slice) pairs or column blocks, several slices without a
// workspace.
//
// 2. The FMA body, sddmm_tile (path 0): float32 (TF32 stays off), bf16
// below 16 tokens, any G and C.  One block owns the G x CT outputs of one
// (row group, slot) pair (CT = C, or a slice of it when G*C would not fit
// the threads' accumulators), keeps them in registers, and walks all N
// tokens in tiles of kBlockTokens, staging g[n-tile, rg*G : rg*G+G] and
// x[n-tile, col0[rg,s]+c0 : +CT] in shared memory (converted to f32) and
// multiplying them with FMAs on the CUDA cores.  No sum crosses blocks and
// there are no atomics, so the order of every sum is fixed and a rerun
// gives the same bits.  The ragged token edge is masked here.  Its grid is
// (M/G) * d_o * d_i blocks, only 64 for wk/wv on 132 SMs, each walking all
// N tokens in series.
//
// rbgp4_sddmm_rhs_stacked, the second entry point, replaces the Pallas TPU
// kernel repro/kernels/rbgp4mm.py:rbgp4_sddmm_rhs_stacked
// (_sddmm_rhs_stacked_kernel): dW[e] = pack(g[e]^T . x[e]) for every expert
// e of a MoE layer in one launch, g (E, N, M), x (E, N, K), dW (E, M,
// d_o*d_i*C), over the one layout (and col0 table) all experts share.  It
// runs the same two device bodies with the expert on the grid: the FMA
// body folds it into blockIdx.z = e*n_slices + slice, and the tensor-core
// body (rbgp4_sddmm_rhs_stacked_mma_kernel<BC, WARPS>, the same device
// function sddmm_mma_tile) into blockIdx.z = e*n_slices + slice too; each
// block offsets g, x, dW (and its partial sums, (E, n_slices, M,
// n_chunks*C), added by rbgp4_sddmm_rhs_stacked_sum_kernel) by its
// expert's stride, so an expert's dW is the bits the unstacked launch of
// the same body and plan gives on that expert's slice.  Each entry point
// launches its own __global__ symbols, so that a profile tells them apart;
// sddmm_path chooses the body from the rows an expert.
//
// What bounds it on an H100.  At a training step of qwen2-moe-a2.7b (171
// token rows an expert, 60 experts, bf16) a gate or up projection reads g
// and x and writes dW, 157 MB, 47 us at 3.35 TB/s, against 15 us for its
// 14.8 GFLOP on the tensor cores.  The contraction is short: 171 tokens,
// so a 128-token stage on 8 warps runs 2 stages, the second 43/128 full,
// and 8 warps' sums are added for eleven k16 steps of work; and at down
// (C = 16, 22 slots a row) a block of one slot owns 256 outputs and
// stages the g tile of its 16 rows again for each of the 22 slots.  What
// the design does about it: the stacked plan (kernels/rbgp4mm.py:
// stacked_sddmm_tile) takes 64-token stages on 4 warps (171 tokens compute
// 192) and blocks of 128 compact columns, which span 8 of down's 16-column
// slots, so one staged g tile serves them all (352 columns: 3 blocks a
// sub-tile, the last 96/128 full).  chip_smoke.py's stacked dW sweep timed
// all eight (16, 32, 64, 128 columns) x (64, 128 tokens) blocks at both
// expert layouts, 16 to 512 rows an expert (NVIDIA H100 80GB HBM3, 700 W):
// 128 x 64 was the fastest at every size, at 171 rows gate/up 0.191 ms
// (128 x 128 0.385, one slot of 16 columns is no choice there) and down
// 0.233 ms against 0.684 for one 16-column slot with 128-token stages
// (the unstacked plan's), so 0.615 ms a MoE layer against the FMA body's
// 9.47.  At 60 experts the grid has 21,120 (gate/up) and 23,040 (down)
// blocks, so one token slice and no workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAccPerThread = 8;  // G * CT <= kThreads * kAccPerThread
constexpr int kBlockTokens = 32;  // tokens staged per pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The FMA body of both entry kernels below: the G x CT outputs of row group
// blockIdx.x, slot blockIdx.y and (expert, column slice) blockIdx.z.
template <typename T>
__device__ __forceinline__ void sddmm_tile(
    const T* __restrict__ g, const T* __restrict__ x,
    const int* __restrict__ col0, T* __restrict__ dw, int n_tokens, int k,
    int m, int n_chunks, int G, int C, int ct, int n_slices) {
  extern __shared__ float smem[];
  float* gs = smem;                      // (kBlockTokens, G)
  float* xs = smem + kBlockTokens * G;   // (kBlockTokens, ct)

  const int rg = blockIdx.x;             // row group: rows rg*G .. +G-1
  const int s = blockIdx.y;              // compact slot of the row group
  const int slice = blockIdx.z % n_slices;
  const int c0 = slice * ct;             // first column of this slice
  const long long w_row = (long long)n_chunks * C;  // compact row length
  // expert e (0 for the unstacked entry point): its operands start at e
  // times their per-expert sizes
  const long long e = blockIdx.z / n_slices;
  g += e * n_tokens * m;
  x += e * n_tokens * k;
  dw += e * m * w_row;
  const int cw = min(ct, C - c0);        // live columns of the slice
  const int tid = threadIdx.x;
  const int n_out = G * ct;
  const int x_col = col0[(long long)rg * n_chunks + s] + c0;

  // output a of this thread: row oi[a] of the group, column oc[a]
  int oi[kAccPerThread], oc[kAccPerThread];
  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int o = tid + a * kThreads;
    oi[a] = o / ct;
    oc[a] = o - oi[a] * ct;
    acc[a] = 0.0f;
  }

  for (int n0 = 0; n0 < n_tokens; n0 += kBlockTokens) {
    // g[n0 : n0+BN, rg*G : rg*G+G], zeros past the token edge
    for (int i = tid; i < kBlockTokens * G; i += kThreads) {
      const int r = i / G;
      const int n = n0 + r;
      float v = 0.0f;
      if (n < n_tokens)
        v = to_f32(g[(long long)n * m + (long long)rg * G + (i - r * G)]);
      gs[i] = v;
    }
    // x[n0 : n0+BN, x_col : x_col+cw]
    for (int i = tid; i < kBlockTokens * ct; i += kThreads) {
      const int r = i / ct;
      const int c = i - r * ct;
      const int n = n0 + r;
      float v = 0.0f;
      if (n < n_tokens && c < cw)
        v = to_f32(x[(long long)n * k + x_col + c]);
      xs[i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      if (tid + a * kThreads < n_out) {
        const float* gr = gs + oi[a];
        const float* xr = xs + oc[a];
        float sum = acc[a];
#pragma unroll 8
        for (int r = 0; r < kBlockTokens; ++r)
          sum = fmaf(gr[r * G], xr[r * ct], sum);
        acc[a] = sum;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    if (tid + a * kThreads < n_out && oc[a] < cw) {
      const long long row = (long long)rg * G + oi[a];
      dw[row * w_row + (long long)s * C + c0 + oc[a]] = from_f32<T>(acc[a]);
    }
  }
}

// Two entry kernels with one body, so that a profile of the card tells
// the stacked launches from the others.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rbgp4_sddmm_rhs_kernel(const T* __restrict__ g, const T* __restrict__ x,
                           const int* __restrict__ col0, T* __restrict__ dw,
                           int n_tokens, int k, int m, int n_chunks, int G,
                           int C, int ct, int n_slices) {
  sddmm_tile<T>(g, x, col0, dw, n_tokens, k, m, n_chunks, G, C, ct,
                n_slices);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rbgp4_sddmm_rhs_stacked_kernel(
    const T* __restrict__ g, const T* __restrict__ x,
    const int* __restrict__ col0, T* __restrict__ dw, int n_tokens, int k,
    int m, int n_chunks, int G, int C, int ct, int n_slices) {
  sddmm_tile<T>(g, x, col0, dw, n_tokens, k, m, n_chunks, G, C, ct,
                n_slices);
}

// -- the bf16 tensor-core body ---------------------------------------------

constexpr int kMmaStages = 3;  // cp.async ring depth

// A block of the tensor-core body: WARPS warps, each 16 tokens of a stage
// (kBK = 16 * WARPS tokens a stage), by BC compact columns of one row
// group's compact row (one slot's columns, or several slots' where BC > C).
template <int BC, int WARPS>
struct SddmmMma {
  static constexpr int kThreads = WARPS * 32;
  static constexpr int kBK = 16 * WARPS;  // tokens a stage
  static constexpr int kNT = BC / 8;      // n8 tiles of a warp
  static constexpr int kXW = BC / 8;      // 16-byte chunks of an x row
  static constexpr int kLD = BC + 8;      // f32 row stride of a warp's sums
  static constexpr size_t kStage =
      (size_t)kBK * (16 + BC) * sizeof(__nv_bfloat16);
  static constexpr size_t kRed = (size_t)WARPS * 16 * kLD * sizeof(float);
  static constexpr size_t kSmem =
      kMmaStages * kStage > kRed ? kMmaStages * kStage : kRed;
  static_assert(BC % 16 == 0 && BC <= 128, "block columns");
  static_assert(WARPS == 4 || WARPS == 8, "warps a block");
};

// The tensor-core body of both mma entry kernels below: the 16 x BC
// outputs dW[r0 : r0+16, j0 : j0+BC] of row sub-tile blockIdx.x (r0 =
// 16*blockIdx.x, row group r0 / G) and compact columns j0 = BC*blockIdx.y
// of that row (columns past n_chunks*C are neither read nor written), over
// the tokens of slice `slice` (slice_len of them, the last one ragged), on
// operands already offset to the block's expert.  Compact column j = s*C +
// c meets input column col0[rg, s] + c: every 16-byte chunk of the block's
// columns lies in one slot (C % 16 == 0), so each thread gathers one fixed
// chunk of every staged x row, computed once.  The tokens are the mma's
// contraction: each stage brings kBK tokens of g[n, r0 : r0+16] and of the
// block's x columns by 16-byte cp.async into a ring of kMmaStages, and warp
// w multiplies the stage's tokens 16w .. 16w+15 (ldmatrix.trans turns both
// token-major tiles into the row-major A = g^T and the col-major B = x
// fragments).  At the end the warps' f32 sums are added in warp order
// through shared memory, and each thread writes 8 consecutive outputs of a
// row with one 16-byte store: with one slice dW in bf16, with more its f32
// partial sums to part[slice] for the slice sum.
template <int BC, int WARPS>
__device__ __forceinline__ void sddmm_mma_tile(
    const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ x,
    const int* __restrict__ col0, __nv_bfloat16* __restrict__ dw,
    float* __restrict__ part, int n_tokens, int k, int m, int n_chunks,
    int G, int C, int slice, int slice_len) {
  using S = SddmmMma<BC, WARPS>;
  using mma_bf16::swz;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* xs = gs + kMmaStages * S::kBK * 16;

  const int r0 = blockIdx.x * 16;
  const int rg = r0 / G;
  const int len = n_chunks * C;         // compact columns of a row
  const int j0 = blockIdx.y * BC;
  const int t0 = slice * slice_len;
  const int t1 = min(n_tokens, t0 + slice_len);
  const int n_steps = (t1 - t0 + S::kBK - 1) / S::kBK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // this thread's chunk xj of every staged x row: compact columns
  // j0 + 8*xj .. +7, input columns x_col .. +7 (kXW divides kThreads)
  const int xj = tid % S::kXW;
  const int xk = j0 + xj * 8;
  const bool x_in = xk < len;
  int x_col = 0;
  if (x_in) {
    const int s = xk / C;
    x_col = col0[(long long)rg * n_chunks + s] + (xk - s * C);
  }

  auto load_stage = [&](int step, int slot) {
    __nv_bfloat16* gd = gs + slot * S::kBK * 16;
    __nv_bfloat16* xd = xs + slot * S::kBK * BC;
    const int nb = t0 + step * S::kBK;
    {
      // g: kBK tokens x 2 chunks, one a thread
      const int r = tid >> 1, j = tid & 1;
      const int n = nb + r;
      const bool ok = n < t1;
      const __nv_bfloat16* src = ok ? g + (long long)n * m + r0 + j * 8 : g;
      mma_bf16::cp_async16(gd + swz<2>(r, j), src, ok);
    }
    // x: kBK tokens x kXW chunks
#pragma unroll
    for (int r = tid / S::kXW; r < S::kBK; r += S::kThreads / S::kXW) {
      const int n = nb + r;
      const bool ok = n < t1 && x_in;
      const __nv_bfloat16* src = ok ? x + (long long)n * k + x_col : x;
      mma_bf16::cp_async16(xd + swz<S::kXW>(r, xj), src, ok);
    }
  };

  float acc[S::kNT][4];
#pragma unroll
  for (int t = 0; t < S::kNT; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[t][q] = 0.0f;

#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < n_steps) load_stage(st, st);
    mma_bf16::cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    mma_bf16::cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    const int next = step + kMmaStages - 1;
    if (next < n_steps) load_stage(next, next % kMmaStages);
    mma_bf16::cp_async_commit();
    const int slot = step % kMmaStages;
    const __nv_bfloat16* gt = gs + slot * S::kBK * 16;
    const __nv_bfloat16* xt = xs + slot * S::kBK * BC;
    const int q = lane >> 3;        // which 8x8 matrix this lane addresses
    const int rr = warp * 16 + (lane & 7);
    // A = g^T (16 rows x 16 tokens): matrices (rows 0-7, tokens 0-7),
    // (rows 8-15, tokens 0-7), (rows 0-7, tokens 8-15), (rows 8-15,
    // tokens 8-15), each read transposed from the token-major tile
    uint32_t a[4];
    mma_bf16::ldmatrix_x4_trans(a, gt + swz<2>(rr + ((q >> 1) << 3), q & 1));
#pragma unroll
    for (int t = 0; t < S::kNT / 2; ++t) {
      // B = x (16 tokens x 16 columns): matrices (tokens 0-7, cols 0-7),
      // (tokens 8-15, cols 0-7), (tokens 0-7, cols 8-15), (tokens 8-15,
      // cols 8-15) = b0, b1 of n8 tile 2t and of tile 2t+1
      uint32_t b[4];
      mma_bf16::ldmatrix_x4_trans(
          b, xt + swz<S::kXW>(rr + ((q & 1) << 3), 2 * t + (q >> 1)));
      mma_bf16::mma_16816(acc[2 * t], a, b[0], b[1]);
      mma_bf16::mma_16816(acc[2 * t + 1], a, b[2], b[3]);
    }
  }
  mma_bf16::cp_async_wait<0>();
  __syncthreads();  // the ring is reused for the warps' sums

  // warp w's sums as a 16 x BC f32 tile: c0, c1 at (row lane/4, columns
  // 8t + 2*(lane%4) + {0, 1}), c2, c3 eight rows further
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int t = 0; t < S::kNT; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = (lane >> 2) + ((q >> 1) << 3);
      const int col = t * 8 + (lane & 3) * 2 + (q & 1);
      red[(warp * 16 + row) * S::kLD + col] = acc[t][q];
    }
  __syncthreads();
  const long long w_row = len;
  for (int c = tid; c < 16 * S::kXW; c += S::kThreads) {
    const int row = c / S::kXW, c8 = (c % S::kXW) * 8;
    if (j0 + c8 >= len) continue;
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = 0.0f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi)
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] += red[(wi * 16 + row) * S::kLD + c8 + u];
    const long long idx = (long long)(r0 + row) * w_row + j0 + c8;
    if (part != nullptr) {
      float4* p = reinterpret_cast<float4*>(
          part + (long long)slice * m * w_row + idx);
      p[0] = make_float4(v[0], v[1], v[2], v[3]);
      p[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      *reinterpret_cast<uint4*>(dw + idx) = make_uint4(
          mma_bf16::pack_bf16x2(v[0], v[1]), mma_bf16::pack_bf16x2(v[2], v[3]),
          mma_bf16::pack_bf16x2(v[4], v[5]), mma_bf16::pack_bf16x2(v[6], v[7]));
    }
  }
}

// Two entry kernels with one tensor-core body, so that a profile of the
// card tells the stacked launches from the others.  blockIdx.z is the
// token slice; for the stacked entry point, e*n_slices + slice of expert
// e, whose g, x, dW and partial sums start at e times their per-expert
// sizes.
template <int BC, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    rbgp4_sddmm_rhs_mma_kernel(const __nv_bfloat16* __restrict__ g,
                               const __nv_bfloat16* __restrict__ x,
                               const int* __restrict__ col0,
                               __nv_bfloat16* __restrict__ dw,
                               float* __restrict__ part, int n_tokens,
                               int k, int m, int n_chunks, int G, int C,
                               int n_slices, int slice_len) {
  sddmm_mma_tile<BC, WARPS>(g, x, col0, dw, part, n_tokens, k, m, n_chunks,
                            G, C, blockIdx.z, slice_len);
}

template <int BC, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
    rbgp4_sddmm_rhs_stacked_mma_kernel(const __nv_bfloat16* __restrict__ g,
                                       const __nv_bfloat16* __restrict__ x,
                                       const int* __restrict__ col0,
                                       __nv_bfloat16* __restrict__ dw,
                                       float* __restrict__ part,
                                       int n_tokens, int k, int m,
                                       int n_chunks, int G, int C,
                                       int n_slices, int slice_len) {
  const long long e = blockIdx.z / n_slices;
  const long long w_size = (long long)m * n_chunks * C;
  g += e * n_tokens * m;
  x += e * n_tokens * k;
  dw += e * w_size;
  if (part != nullptr) part += e * n_slices * w_size;
  sddmm_mma_tile<BC, WARPS>(g, x, col0, dw, part, n_tokens, k, m, n_chunks,
                            G, C, blockIdx.z % n_slices, slice_len);
}

// dW[e, i] = expert e's slices' partial sums (part (E, n_slices, total))
// added in slice order, in bf16; two symbols, as the entry kernels.
__device__ __forceinline__ void sum_slices(const float* __restrict__ part,
                                           __nv_bfloat16* __restrict__ dw,
                                           long long total, int n_experts,
                                           int n_slices) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_experts * total; i += (long long)gridDim.x * blockDim.x) {
    const long long e = i / total;
    const float* p = part + e * n_slices * total + (i - e * total);
    float v = 0.0f;
    for (int z = 0; z < n_slices; ++z) v += p[(long long)z * total];
    dw[i] = __float2bfloat16(v);
  }
}

__global__ void __launch_bounds__(256)
    rbgp4_sddmm_rhs_sum_kernel(const float* __restrict__ part,
                               __nv_bfloat16* __restrict__ dw,
                               long long total, int n_experts, int n_slices) {
  sum_slices(part, dw, total, n_experts, n_slices);
}

__global__ void __launch_bounds__(256)
    rbgp4_sddmm_rhs_stacked_sum_kernel(const float* __restrict__ part,
                                       __nv_bfloat16* __restrict__ dw,
                                       long long total, int n_experts,
                                       int n_slices) {
  sum_slices(part, dw, total, n_experts, n_slices);
}

template <int BC, int WARPS>
cudaError_t launch_mma_tile(const void* g, const void* x, const void* col0,
                            void* dw, void* part, bool stacked,
                            int n_experts, int n_tokens, int k, int m,
                            int n_chunks, int G, int C, int n_slices,
                            int slice_len, cudaStream_t stream) {
  using S = SddmmMma<BC, WARPS>;
  const auto kernel = stacked ? rbgp4_sddmm_rhs_stacked_mma_kernel<BC, WARPS>
                              : rbgp4_sddmm_rhs_mma_kernel<BC, WARPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return err;
  const int len = n_chunks * C;
  const dim3 grid(m / 16, (len + BC - 1) / BC, n_slices * n_experts);
  kernel<<<grid, S::kThreads, S::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(col0),
      static_cast<__nv_bfloat16*>(dw),
      n_slices > 1 ? static_cast<float*>(part) : nullptr, n_tokens, k, m,
      n_chunks, G, C, n_slices, slice_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_slices == 1) return err;
  const long long total = (long long)m * len;
  long long blocks = (n_experts * total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  const auto sum = stacked ? rbgp4_sddmm_rhs_stacked_sum_kernel
                           : rbgp4_sddmm_rhs_sum_kernel;
  sum<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dw),
      total, n_experts, n_slices);
  return cudaGetLastError();
}

template <int WARPS>
cudaError_t launch_mma_warps(const void* g, const void* x, const void* col0,
                             void* dw, void* part, bool stacked,
                             int n_experts, int n_tokens, int k, int m,
                             int n_chunks, int G, int C, int block_cols,
                             int n_slices, int slice_len,
                             cudaStream_t stream) {
  switch (block_cols) {
    case 16:
      return launch_mma_tile<16, WARPS>(g, x, col0, dw, part, stacked,
                                        n_experts, n_tokens, k, m, n_chunks,
                                        G, C, n_slices, slice_len, stream);
    case 32:
      return launch_mma_tile<32, WARPS>(g, x, col0, dw, part, stacked,
                                        n_experts, n_tokens, k, m, n_chunks,
                                        G, C, n_slices, slice_len, stream);
    case 64:
      return launch_mma_tile<64, WARPS>(g, x, col0, dw, part, stacked,
                                        n_experts, n_tokens, k, m, n_chunks,
                                        G, C, n_slices, slice_len, stream);
    case 128:
      return launch_mma_tile<128, WARPS>(g, x, col0, dw, part, stacked,
                                         n_experts, n_tokens, k, m,
                                         n_chunks, G, C, n_slices,
                                         slice_len, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The mma body: bf16 only, G and C multiples of 16, K a multiple of 8,
// g and x 16-byte aligned, block_cols in {16, 32, 64, 128},
// stage_tokens 64 (4 warps) or 128 (8 warps), and a slice plan that
// covers each expert's tokens exactly: slice_len a multiple of
// stage_tokens, n_slices = ceil(n_tokens / slice_len), a workspace when
// there is more than one slice.  Anything else is refused.
cudaError_t launch_mma(const void* g, const void* x, const void* col0,
                       void* dw, void* part, bool stacked, int n_experts,
                       int n_tokens, int k, int m, int n_chunks, int G,
                       int C, int block_cols, int stage_tokens,
                       int n_slices, int slice_len, cudaStream_t stream) {
  if (n_tokens < 1 || n_chunks < 1 || n_experts < 1 || G < 16 ||
      G % 16 != 0 || m % G != 0 || C < 16 || C % 16 != 0 || k % 8 != 0 ||
      !mma_bf16::aligned16(g) || !mma_bf16::aligned16(x) ||
      (stage_tokens != 64 && stage_tokens != 128) ||
      slice_len < stage_tokens || slice_len % stage_tokens != 0 ||
      n_slices < 1 || (long long)n_slices * n_experts > 65535 ||
      (long long)(n_slices - 1) * slice_len >= n_tokens ||
      (long long)n_slices * slice_len < n_tokens || block_cols < 16 ||
      ((long long)n_chunks * C + block_cols - 1) / block_cols > 65535 ||
      (n_slices > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  if (stage_tokens == 64)
    return launch_mma_warps<4>(g, x, col0, dw, part, stacked, n_experts,
                               n_tokens, k, m, n_chunks, G, C, block_cols,
                               n_slices, slice_len, stream);
  return launch_mma_warps<8>(g, x, col0, dw, part, stacked, n_experts,
                             n_tokens, k, m, n_chunks, G, C, block_cols,
                             n_slices, slice_len, stream);
}

template <typename T>
cudaError_t launch(const void* g, const void* x, const void* col0, void* dw,
                   bool stacked, int n_experts, int n_tokens, int k, int m,
                   int n_chunks, int G, int C, cudaStream_t stream) {
  if (G < 1 || C < 1 || m % G != 0 || n_chunks < 1 || n_tokens < 1 ||
      n_experts < 1 || G > kThreads * kAccPerThread)
    return cudaErrorInvalidValue;
  // columns per block: all C when the G x C outputs fit the accumulators
  const int cap = kThreads * kAccPerThread / G;
  const int ct = C < cap ? C : cap;
  const size_t smem = (size_t)kBlockTokens * (G + ct) * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const int n_slices = (C + ct - 1) / ct;
  if ((long long)n_slices * n_experts > 65535) return cudaErrorInvalidValue;
  const dim3 grid(m / G, n_chunks, n_slices * n_experts);
  const auto kernel = stacked ? rbgp4_sddmm_rhs_stacked_kernel<T>
                              : rbgp4_sddmm_rhs_kernel<T>;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const int*>(col0), static_cast<T*>(dw), n_tokens, k, m,
      n_chunks, G, C, ct, n_slices);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (g, x and dW all of it).  path: 0 the
// FMA body, 1 the bf16 tensor-core body (the caller's choice,
// kernels/rbgp4mm.py:sddmm_path), which takes the caller's plan
// (kernels/rbgp4mm.py:sddmm_mma_plan): block_cols compact columns a
// block, stage_tokens tokens a stage, n_slices slices of slice_len tokens,
// and `part`, a float32 workspace of (n_slices, M, n_chunks*C) when
// n_slices > 1 (else null).  The FMA body ignores the plan.  Returns the
// cudaError_t of the launch.
extern "C" int rbgp4_sddmm_rhs_launch(int dtype, const void* g, const void* x,
                                      const void* col0, void* dw, void* part,
                                      int n_tokens, int k, int m,
                                      int n_chunks, int G, int C, int path,
                                      int block_cols, int stage_tokens,
                                      int n_slices, int slice_len,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(g, x, col0, dw, part, false, 1, n_tokens, k, m,
                           n_chunks, G, C, block_cols, stage_tokens,
                           n_slices, slice_len, s);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(g, x, col0, dw, false, 1, n_tokens, k, m,
                              n_chunks, G, C, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(g, x, col0, dw, false, 1, n_tokens, k,
                                      m, n_chunks, G, C, s);
  return (int)cudaErrorInvalidValue;
}

// The stacked entry point: g (E, N, M), x (E, N, K), dW (E, M,
// n_chunks*C), one launch for all E experts over the one col0 table.
// path and the plan as above, per expert (kernels/rbgp4mm.py:
// stacked_sddmm_mma_plan); `part` then holds (E, n_slices, M,
// n_chunks*C).  Returns the cudaError_t of the launch.
extern "C" int rbgp4_sddmm_rhs_stacked_launch(
    int dtype, const void* g, const void* x, const void* col0, void* dw,
    void* part, int n_experts, int n_tokens, int k, int m, int n_chunks,
    int G, int C, int path, int block_cols, int stage_tokens, int n_slices,
    int slice_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(g, x, col0, dw, part, true, n_experts, n_tokens, k,
                           m, n_chunks, G, C, block_cols, stage_tokens,
                           n_slices, slice_len, s);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(g, x, col0, dw, true, n_experts, n_tokens, k,
                              m, n_chunks, G, C, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(g, x, col0, dw, true, n_experts,
                                      n_tokens, k, m, n_chunks, G, C, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rbgp4_sddmm_rhs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
