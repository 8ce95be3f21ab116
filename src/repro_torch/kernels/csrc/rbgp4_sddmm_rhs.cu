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
// and passed as `path`, with the tensor-core body's token-slice plan
// (kernels/rbgp4mm.py:sddmm_mma_plan, a pure function of the shapes and
// the card's SM count); the launcher refuses a shape or plan the chosen
// body cannot take, and nothing falls back from one body to the other.
//
// 1. The bf16 tensor-core body, rbgp4_sddmm_rhs_mma_kernel<BC> and
// rbgp4_sddmm_rhs_sum_kernel (path 1): the unstacked entry point in
// bfloat16 at N >= 16 tokens, G and C multiples of 16, K a multiple of 8:
// every dW launch of a training step.
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
// H100 80GB HBM3, 700 W, chip_smoke.py phase 3): 1.06 ms a layer.
//
// What the design does about it.  Tokens are the contraction.  A block
// owns the 16 x BC outputs dW[r0 : r0+16, s*C + c0 : +BC] (16 rows of a
// row group, BC = 128, 64, 32 or 16 columns of slot s: the widest that
// divides C) over one token slice.  Each stage brings 128 tokens of
// g[n, r0 : r0+16] (two 16-byte chunks a token) and of x[n, col0[rg, s] +
// c0 : +BC] by 16-byte cp.async into a ring of 3 stages (rows XOR-
// swizzled by chunk for conflict-free ldmatrix); warp w multiplies the
// stage's tokens 16w .. 16w+15 with mma.sync m16n8k16: ldmatrix.trans
// turns the token-major g tile into the row-major A = g^T fragment and
// the token-major x tile into the col-major B = x fragment, so nothing is
// transposed in memory.  Each warp keeps 16 x BC f32 sums (64 registers
// of sums at BC = 128); at the end the eight warps' sums are added in
// warp order through the (reused) ring.  The token range is cut into
// n_slices slices of slice_len tokens (a multiple of 128, at least 256)
// so that the grid reaches two waves of blocks on the card's SMs: at N =
// 4096 only wk/wv is cut (64 pairs: 5 slices of 896 tokens, 320 blocks);
// wq/wo, gate/up and down have 512, 1408 and 2816 blocks uncut.  With
// one slice a block writes dW in bf16; with more it writes f32 partial
// sums to a workspace (n_slices, M, n_chunks*C) the wrapper allocates,
// and rbgp4_sddmm_rhs_sum_kernel adds the slices in slice order and
// writes dW.  No atomics: every sum's order is fixed by the shapes, so a
// rerun gives the same bits.  The ragged token edge is zero-filled by the
// copy itself (src-size 0).
//
// Build (nvcc -Xptxas -v, sm_90a): BC = 16, 32, 64, 128 use 52, 64, 100
// and 124 registers and no stack (no spills), the slice sum 32; dynamic
// shared memory max(3 * 128 * (16 + BC) * 2, 8 * 16 * BC * 4) = 24,576,
// 36,864, 61,440 and 110,592 bytes (each launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize).  Refused (launcher):
// float32, G or C not a multiple of 16, K not a multiple of 8, g or x not
// 16-byte aligned (the wrapper checks first and raises), a plan whose
// slices do not cover the tokens exactly in whole stages, more than 65535
// slices or (slot, column block) pairs, several slices without a
// workspace.
//
// 2. The FMA body, sddmm_tile (path 0): float32 (TF32 stays off), bf16
// below 16 tokens, the stacked entry point, any G and C.  One block owns
// the G x CT outputs of one (row group, slot) pair (CT = C, or a slice of
// it when G*C would not fit the threads' accumulators), keeps them in
// registers, and walks all N tokens in tiles of kBlockTokens, staging
// g[n-tile, rg*G : rg*G+G] and x[n-tile, col0[rg,s]+c0 : +CT] in shared
// memory (converted to f32) and multiplying them with FMAs on the CUDA
// cores.  No sum crosses blocks and there are no atomics, so the order of
// every sum is fixed and a rerun gives the same bits.  The ragged token
// edge is masked here.  Its grid is (M/G) * d_o * d_i blocks, only 64
// for wk/wv on 132 SMs, each walking all N tokens in series.
//
// rbgp4_sddmm_rhs_stacked, the second entry point, replaces the Pallas TPU
// kernel repro/kernels/rbgp4mm.py:rbgp4_sddmm_rhs_stacked
// (_sddmm_rhs_stacked_kernel): dW[e] = pack(g[e]^T . x[e]) for every expert
// e of a MoE layer in one launch, g (E, N, M), x (E, N, K), dW (E, M,
// d_o*d_i*C), over the one layout (and col0 table) all experts share.  It
// is the same device body (sddmm_tile) with the expert folded into
// blockIdx.z = e*n_slices + slice; each block offsets g, x and dW by its
// expert's stride.  The unstacked entry point is its E = 1 case; each
// entry point launches its own __global__ symbol, so that a profile tells
// them apart.  What bounds it on
// an H100: bytes.  At a training step of qwen2-moe-a2.7b (171 token rows
// an expert, bf16) a gate or up projection reads g and x and writes dW,
// 157 MB, 47 us at 3.35 TB/s, against 15 us for its 14.8 GFLOP on the
// tensor cores.  What the design does about it: nothing yet, it is the
// FMA body above; the stacked entry point is the next to take the
// tensor-core body.

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

constexpr int kMmaThreads = 256;     // 8 warps
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMmaBK = 16 * kMmaWarps;  // tokens a stage: 16 a warp
constexpr int kMmaStages = 3;           // cp.async ring depth

template <int BC>
struct SddmmMma {
  static constexpr int kNT = BC / 8;    // n8 tiles of a warp
  static constexpr int kXW = BC / 8;    // 16-byte chunks of an x row
  static constexpr size_t kStage =
      (size_t)kMmaBK * (16 + BC) * sizeof(__nv_bfloat16);
  static constexpr size_t kRed =
      (size_t)kMmaWarps * 16 * BC * sizeof(float);
  static constexpr size_t kSmem =
      kMmaStages * kStage > kRed ? kMmaStages * kStage : kRed;
  static_assert(BC % 16 == 0 && BC <= 128, "block columns");
};

// The 16 x BC outputs dW[r0 : r0+16, s*C + c0 : +BC] of row sub-tile
// blockIdx.x (r0 = 16*blockIdx.x, row group r0 / G), slot and column
// slice blockIdx.y = s*(C/BC) + c0/BC, over the tokens of slice
// blockIdx.z (slice_len of them, the last one ragged).  The tokens are
// the mma's contraction: each stage brings kMmaBK tokens of
// g[n, r0 : r0+16] and x[n, col0[rg, s] + c0 : +BC] by 16-byte cp.async
// into a ring of kMmaStages, and warp w multiplies the stage's tokens
// 16w .. 16w+15 (ldmatrix.trans turns both token-major tiles into the
// row-major A = g^T and the col-major B = x fragments).  At the end the
// eight warps' f32 sums are added in warp order through shared memory;
// with one slice the block writes dW in bf16, with more it writes its f32
// partial sums to part[slice] for rbgp4_sddmm_rhs_sum_kernel.
template <int BC>
__global__ void __launch_bounds__(kMmaThreads)
    rbgp4_sddmm_rhs_mma_kernel(const __nv_bfloat16* __restrict__ g,
                               const __nv_bfloat16* __restrict__ x,
                               const int* __restrict__ col0,
                               __nv_bfloat16* __restrict__ dw,
                               float* __restrict__ part, int n_tokens,
                               int k, int m, int n_chunks, int G, int C,
                               int slice_len) {
  using S = SddmmMma<BC>;
  using mma_bf16::swz;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* xs = gs + kMmaStages * kMmaBK * 16;

  const int r0 = blockIdx.x * 16;
  const int rg = r0 / G;
  const int n_cs = C / BC;
  const int s = blockIdx.y / n_cs;
  const int c0 = (blockIdx.y - s * n_cs) * BC;
  const int t0 = blockIdx.z * slice_len;
  const int t1 = min(n_tokens, t0 + slice_len);
  const int n_steps = (t1 - t0 + kMmaBK - 1) / kMmaBK;
  const int x_col = col0[(long long)rg * n_chunks + s] + c0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  auto load_stage = [&](int step, int slot) {
    __nv_bfloat16* gd = gs + slot * kMmaBK * 16;
    __nv_bfloat16* xd = xs + slot * kMmaBK * BC;
    const int nb = t0 + step * kMmaBK;
    // g: kMmaBK tokens x 2 chunks
    for (int i = tid; i < kMmaBK * 2; i += kMmaThreads) {
      const int r = i >> 1, j = i & 1;
      const int n = nb + r;
      const bool ok = n < t1;
      const __nv_bfloat16* src = ok ? g + (long long)n * m + r0 + j * 8 : g;
      mma_bf16::cp_async16(gd + swz<2>(r, j), src, ok);
    }
    // x: kMmaBK tokens x kXW chunks
#pragma unroll
    for (int i = tid; i < kMmaBK * S::kXW; i += kMmaThreads) {
      const int r = i / S::kXW, j = i % S::kXW;
      const int n = nb + r;
      const bool ok = n < t1;
      const __nv_bfloat16* src =
          ok ? x + (long long)n * k + x_col + j * 8 : x;
      mma_bf16::cp_async16(xd + swz<S::kXW>(r, j), src, ok);
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
    const __nv_bfloat16* gt = gs + slot * kMmaBK * 16;
    const __nv_bfloat16* xt = xs + slot * kMmaBK * BC;
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

  float* red = reinterpret_cast<float*>(smem_raw);
  constexpr int kPer = S::kNT * 4 * 32;  // one warp's sums
#pragma unroll
  for (int t = 0; t < S::kNT; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      red[warp * kPer + (t * 4 + q) * 32 + lane] = acc[t][q];
  __syncthreads();
  const long long w_row = (long long)n_chunks * C;
  for (int e = tid; e < kPer; e += kMmaThreads) {
    float v = 0.0f;
#pragma unroll
    for (int wi = 0; wi < kMmaWarps; ++wi) v += red[wi * kPer + e];
    // fragment entry e = (t*4 + q)*32 + l: row l/4 (+8 for q >= 2),
    // column 8t + 2*(l%4) + (q & 1)
    const int l = e & 31, tq = e >> 5;
    const int t = tq >> 2, qq = tq & 3;
    const int row = r0 + (l >> 2) + ((qq >> 1) << 3);
    const int col = s * C + c0 + t * 8 + (l & 3) * 2 + (qq & 1);
    const long long idx = (long long)row * w_row + col;
    if (part != nullptr)
      part[(long long)blockIdx.z * m * w_row + idx] = v;
    else
      dw[idx] = __float2bfloat16(v);
  }
}

// dW[i] = the slices' partial sums added in slice order, in bf16.
__global__ void __launch_bounds__(256)
    rbgp4_sddmm_rhs_sum_kernel(const float* __restrict__ part,
                               __nv_bfloat16* __restrict__ dw,
                               long long total, int n_slices) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int z = 0; z < n_slices; ++z) v += part[(long long)z * total + i];
    dw[i] = __float2bfloat16(v);
  }
}

template <int BC>
cudaError_t launch_mma_bc(const void* g, const void* x, const void* col0,
                          void* dw, void* part, int n_tokens, int k, int m,
                          int n_chunks, int G, int C, int n_slices,
                          int slice_len, cudaStream_t stream) {
  using S = SddmmMma<BC>;
  const auto kernel = rbgp4_sddmm_rhs_mma_kernel<BC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(m / 16, n_chunks * (C / BC), n_slices);
  kernel<<<grid, kMmaThreads, S::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(col0),
      static_cast<__nv_bfloat16*>(dw),
      n_slices > 1 ? static_cast<float*>(part) : nullptr, n_tokens, k, m,
      n_chunks, G, C, slice_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_slices == 1) return err;
  const long long total = (long long)m * n_chunks * C;
  long long blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  rbgp4_sddmm_rhs_sum_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dw),
      total, n_slices);
  return cudaGetLastError();
}

// The mma body: bf16 only, G and C multiples of 16, K a multiple of 8,
// g and x 16-byte aligned, block_cols in {16, 32, 64, 128} dividing C,
// and a slice plan that covers the tokens exactly: slice_len a multiple
// of kMmaBK, n_slices = ceil(n_tokens / slice_len), a workspace when
// there is more than one slice.  Anything else is refused.
cudaError_t launch_mma(const void* g, const void* x, const void* col0,
                       void* dw, void* part, int n_tokens, int k, int m,
                       int n_chunks, int G, int C, int block_cols,
                       int n_slices, int slice_len, cudaStream_t stream) {
  if (n_tokens < 1 || n_chunks < 1 || G < 16 || G % 16 != 0 ||
      m % G != 0 || C < 16 || C % 16 != 0 || k % 8 != 0 ||
      !mma_bf16::aligned16(g) || !mma_bf16::aligned16(x) ||
      block_cols < 16 ||
      C % block_cols != 0 || slice_len < kMmaBK ||
      slice_len % kMmaBK != 0 || n_slices < 1 || n_slices > 65535 ||
      (long long)(n_slices - 1) * slice_len >= n_tokens ||
      (long long)n_slices * slice_len < n_tokens ||
      (long long)n_chunks * (C / block_cols) > 65535 ||
      (n_slices > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  switch (block_cols) {
    case 16:
      return launch_mma_bc<16>(g, x, col0, dw, part, n_tokens, k, m,
                               n_chunks, G, C, n_slices, slice_len, stream);
    case 32:
      return launch_mma_bc<32>(g, x, col0, dw, part, n_tokens, k, m,
                               n_chunks, G, C, n_slices, slice_len, stream);
    case 64:
      return launch_mma_bc<64>(g, x, col0, dw, part, n_tokens, k, m,
                               n_chunks, G, C, n_slices, slice_len, stream);
    case 128:
      return launch_mma_bc<128>(g, x, col0, dw, part, n_tokens, k, m,
                                n_chunks, G, C, n_slices, slice_len, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
// (kernels/rbgp4mm.py:sddmm_mma_plan): block_cols columns of C a block,
// n_slices slices of slice_len tokens, and `part`, a float32 workspace of
// (n_slices, M, n_chunks*C) when n_slices > 1 (else null).  The FMA body
// ignores the plan.  Returns the cudaError_t of the launch.
extern "C" int rbgp4_sddmm_rhs_launch(int dtype, const void* g, const void* x,
                                      const void* col0, void* dw, void* part,
                                      int n_tokens, int k, int m,
                                      int n_chunks, int G, int C, int path,
                                      int block_cols, int n_slices,
                                      int slice_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(g, x, col0, dw, part, n_tokens, k, m, n_chunks,
                           G, C, block_cols, n_slices, slice_len, s);
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
// Returns the cudaError_t of the launch.
extern "C" int rbgp4_sddmm_rhs_stacked_launch(int dtype, const void* g,
                                              const void* x,
                                              const void* col0, void* dw,
                                              int n_experts, int n_tokens,
                                              int k, int m, int n_chunks,
                                              int G, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
