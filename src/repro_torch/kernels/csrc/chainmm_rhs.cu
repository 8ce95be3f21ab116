// chainmm_rhs for Hopper (sm_90a): Y = X . W_s^T, token-major, with W_s in
// the blocked-CSR storage of a deep RBGP product chain.
//
// Replaces the Pallas TPU kernel repro/kernels/chainmm.py:chainmm_rhs
// (_chain_rhs_kernel, _chain_rhs_accumulate), with the int8 `scales`
// path (has_scales; see the end of this note).  Training runs it three
// ways: the forward of every chain projection, its recompute under
// activation checkpointing, and
// dX = g . W_s as this kernel on the transposed layout's table over the
// permuted values.  It has no epilogue: bias, activation and residual run
// in torch after it, as in the reference.
//
// What it computes.  w (M, R) holds each row's R = n_chunks*C stored
// values.  The chain's trailing complete factors make every G consecutive
// rows share their columns and every C consecutive stored values C
// consecutive input columns, so one host-built table col0 (M/G, n_chunks)
// holds the layout: row rg*G + g, stored column j = s*C + c multiplies
// input column col0[rg, s] + c.  The table replaces the TPU kernel's
// scalar-prefetched head adjacency (its grid-level skip of zero head
// tiles) and its static unroll of the mid factors.  Sums are f32 whatever
// the input type.
//
// Two device bodies.  Which one a launch takes is a fixed function of
// dtype and shape, chosen by the caller (kernels/chainmm.py:
// chain_rhs_path) and passed as `path`, with the class rows of the
// tensor-core body's block (kernels/chainmm.py:chain_rhs_tile_rows); the
// launcher refuses a shape the chosen body cannot take, and nothing falls
// back from one body to the other.
//
// 1. The bf16 tensor-core body, chainmm_rhs_mma_kernel<BR> (path 1):
// bfloat16 at N >= 16 tokens with G, C and K multiples of 8: every
// forward, recompute and dX launch of a training step and every prefill.
// It works over row-group classes (kernels/rbgp4mm.py:RowGroupClasses):
// the row groups whose col0 rows are equal.  The complete 4x4 head factor and
// the complete leaf give whole sets of row groups one column set, so a
// class's rows together are one dense product, Y[:, class rows] =
// X[:, the class's gathered columns] . W[class rows]^T.  tinyllama-1.1b
// under the hierarchical-block plan (classes x rows, R = stored columns a
// row, the contraction): wq/wo 32 x 64, R 256 (forward and transposed);
// wk/wv 8 x 32, R 256 (forward) and 8 x 256, R 32 (transposed); gate/up
// 8 x 704, R 256 (forward) and 8 x 256, R 704 (transposed); down the
// other way round.
//
// What bounds it on an H100.  tinyllama-1.1b under that plan (0.875, leaf
// G x C = 8 x 8 for wq/wo/wk/wv, 16 x 32 for gate/up, 32 x 16 for down)
// stores an eighth of each matrix: at a training step's 4096 rows a
// layer's seven forward launches do 2 * 4096 * 5.51e6 = 45.1 GFLOP, 46 us
// at the 989 TFLOP/s bf16 dense peak, and read X and W and write Y, 0.305
// GB, 91 us at 3.35 TB/s: bytes bound it, and dX the same.  The FMA body
// below re-gathers X for every row group (G = 8 rows) and runs two
// shared-memory loads per FMA.
//
// What the design does about it.  A block owns 128 tokens by BR class
// rows of one class (BR = 64, or 32 where the largest class has 32 rows:
// wk/wv's forward table), rows past the class zero-filled, so one
// gathered X tile serves 32-64 rows instead of G.  Tokens are the mma's M
// side, the class rows its N side and the stored columns j = s*C + c its
// contraction: mma.sync m16n8k16 (bf16 in, f32 sums), fragments by
// ldmatrix.  A class row's R stored values are contiguous, so W's rows
// are the .col B operand as they lie, gathered row group by row group
// through the class table (a thread's rows computed once a block), and
// X's gathered rows the .row A operand.  The contraction runs in stages
// of 64 stored columns (wk/wv's transposed R = 32: one stage, half of it
// zero-filled), each stage's X (128 x 64, gathered 8 columns at a time
// through the class's col0 row: C % 8 == 0, so a 16-byte chunk never
// straddles a leaf chunk) and W (BR x 64) by 16-byte cp.async into a ring
// of 3 stages, rows XOR-swizzled by 16-byte chunk (mma_bf16.cuh).  The 8
// warps split the tile 4 x 2 (BR = 64) or 8 x 1 (BR = 32), 32 or 16
// tokens by 32 rows a warp.  Y is written as the fragments lie: an n8
// tile's eight class rows are eight consecutive rows of one row group (G
// % 8 == 0), so the four lanes of a token write 16 contiguous bytes, one
// bf16x2 store each.  No atomics and no sum crosses blocks: each output's
// sum runs over R in one fixed order, so a rerun gives the same bits.
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 13, N =
// 4096): the forward 0.461 ms a layer (FMA body 8.95), dX 0.455 (8.70),
// a little under F.linear and g @ W on the dense matrices (0.481 and
// 0.474 ms), 5x the bytes bound.  Build (nvcc -Xptxas -v, sm_90a): BR =
// 32 and 64 use 60 and 95 registers, no stack, no spills.  Refusals: see
// the launcher; dynamic shared memory 3 * (128 + BR) * 64
// * 2 = 61,440 (BR = 32) and 73,728 (BR = 64) bytes, above the 48 KB
// default, so each launch sets cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// 2. The FMA body, chain_tile (path 0): float32 (TF32 stays off), bf16
// below 16 tokens (decode), the small leaves (G = C = 1 or 2) and the int8
// path.  What bounds it on an H100: at decode (8 token rows) reading W
// bounds every launch (2 bytes a value, 8 products each).  One block
// computes a (BN tokens x G rows) tile of one row group.  Where the RBGP4
// kernel stages one chunk of C columns per pass, this one walks the row's
// stored columns in passes of kTileK = 64, gathering the input column of
// each through col0 (a pass spans 64 / C chunks: at C = 8, eight), so a
// small leaf still gives 64 FMAs an output between two barriers.  Each
// pass stages the (BN x 64) gathered inputs and the (G x 64) weights in
// shared memory (converted to f32); each thread holds up to four outputs
// in registers; no sum crosses blocks, so the order of every sum is fixed.
// BN is a power of two covering the tokens, at most 128 and at most 1024 /
// G.  The ragged token edge and the row's last pass are masked with zeros.
// Any C works, and any G up to 128 (a larger G is refused: its staging
// would pass the 48 KB of shared memory a launch gets by default).  G = C
// = 1 (a chain with no trailing complete factor) is right and slow: a
// block then holds one row for 128 tokens, and each stored value is one
// gathered input column.
//
// The int8 path (chainmm_rhs_q, its own __global__ symbol; the reference's
// has_scales branch in _chain_rhs_accumulate): weight-only PTQ storage, w
// int8 of the same shape and scales (M/G, n_chunks) float32, one scale per
// (G x C) leaf block.  The table's (G, C) is the leaf, so the scale of
// stored column j of row group rg is scales[rg*n_chunks + j/C], the order
// the reference's quantizer writes.  The same body: the W staging loads
// the int8 value and multiplies it by its chunk's scale in f32 (q * scale,
// as the plain version dequantizes); a pass of 64 columns spans 64/C
// chunks (C > 64 splits a chunk over passes, each column still finding its
// own chunk's scale).  A thread stages one column of W a pass (256
// threads, 64 columns), so it loads that column's scale once a pass.  Sums
// stay f32, X and Y keep their type.  What bounds
// it on an H100: bytes at decode, with a value at 1 byte instead of bf16's
// 2 plus 4/(G*C) bytes of scale (1/16 byte at an 8 x 8 leaf), so a little
// over half the bf16 path's bound; loads stay one byte a thread for now.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAccPerThread = 4;  // BN * G <= kThreads * kAccPerThread
constexpr int kTileK = 64;        // stored columns staged per pass
constexpr int kMaxBlockTokens = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
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

// One (BN tokens x G rows) tile of row group blockIdx.x, token block
// blockIdx.y: the body of both entry kernels below.  W is the value type:
// T, or int8_t with one float scale per leaf block.
template <typename T, typename W>
__device__ __forceinline__ void chain_tile(
    const T* __restrict__ x, const W* __restrict__ w,
    const float* __restrict__ scales, const int* __restrict__ col0,
    T* __restrict__ out, int n_tokens, int k, int m, int n_chunks, int G,
    int C, int bn) {
  constexpr bool kInt8 = std::is_same<W, int8_t>::value;
  extern __shared__ float smem[];
  constexpr int ld = kTileK + 1;  // padded row stride: no bank conflicts
  float* xs = smem;               // (bn, ld)
  float* ws = smem + bn * ld;     // (G, ld)

  const int rg = blockIdx.x;  // row group: output rows rg*G .. rg*G + G-1
  const int n0 = blockIdx.y * bn;
  const int tid = threadIdx.x;
  const int n_out = bn * G;
  const int row_len = n_chunks * C;  // stored columns of a row
  const int* cols = col0 + (long long)rg * n_chunks;
  const W* w_blk = w + (long long)rg * G * row_len;

  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.0f;

  for (int j0 = 0; j0 < row_len; j0 += kTileK) {
    const int jw = min(kTileK, row_len - j0);  // live columns this pass
    // x[n0 : n0+bn, input column of stored column j0 + c], zeros past the
    // token edge and the row's end
    for (int i = tid; i < bn * kTileK; i += kThreads) {
      const int r = i / kTileK;
      const int c = i - r * kTileK;
      const int n = n0 + r;
      float v = 0.0f;
      if (n < n_tokens && c < jw) {
        const int j = j0 + c;
        const int s = j / C;
        v = to_f32(x[(long long)n * k + cols[s] + (j - s * C)]);
      }
      xs[r * ld + c] = v;
    }
    // w[rg*G : rg*G+G, j0 : j0+jw]: a thread stages one column wc of every
    // kThreads / kTileK-th row, so an int8 value's scale (its chunk's) is
    // read once a pass; a T value's scale is 1
    static_assert(kThreads % kTileK == 0, "a thread keeps its column");
    const int wc = tid % kTileK;
    float scale = 1.0f;
    if constexpr (kInt8) {
      if (wc < jw) scale = scales[(long long)rg * n_chunks + (j0 + wc) / C];
    }
    for (int g = tid / kTileK; g < G; g += kThreads / kTileK) {
      float v = 0.0f;
      if (wc < jw) v = to_f32(w_blk[(long long)g * row_len + j0 + wc]) * scale;
      ws[g * ld + wc] = v;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAccPerThread; ++a) {
      const int o = tid + a * kThreads;
      if (o < n_out) {
        const float* xr = xs + (o / G) * ld;
        const float* wr = ws + (o % G) * ld;
        float sum = acc[a];
#pragma unroll 16
        for (int c = 0; c < kTileK; ++c) sum = fmaf(xr[c], wr[c], sum);
        acc[a] = sum;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int o = tid + a * kThreads;
    const int n = n0 + o / G;
    if (o < n_out && n < n_tokens)
      out[(long long)n * m + rg * G + o % G] = from_f32<T>(acc[a]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chainmm_rhs_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const int* __restrict__ col0, T* __restrict__ out,
                       int n_tokens, int k, int m, int n_chunks, int G,
                       int C, int bn) {
  chain_tile<T, T>(x, w, nullptr, col0, out, n_tokens, k, m, n_chunks, G, C,
                   bn);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chainmm_rhs_q_kernel(const T* __restrict__ x,
                         const int8_t* __restrict__ q,
                         const float* __restrict__ scales,
                         const int* __restrict__ col0, T* __restrict__ out,
                         int n_tokens, int k, int m, int n_chunks, int G,
                         int C, int bn) {
  chain_tile<T, int8_t>(x, q, scales, col0, out, n_tokens, k, m, n_chunks,
                        G, C, bn);
}

// Token rows per block: a power of two covering n_tokens (a decode step
// stages no empty rows), at most kMaxBlockTokens, and few enough that the
// block's BN x G outputs fit its threads' accumulators.  0 when G alone is
// too large.
int block_tokens(int n_tokens, int G) {
  int bn = 1;
  while (bn < n_tokens && bn < kMaxBlockTokens) bn *= 2;
  const int cap = kThreads * kAccPerThread / G;
  return bn < cap ? bn : cap;
}

// scales == nullptr: the f32/bf16 kernel over w of type T; else the int8
// kernel over int8 w.
template <typename T>
cudaError_t launch(const void* x, const void* w, const void* scales,
                   const void* col0, void* out, int n_tokens, int k, int m,
                   int n_chunks, int G, int C, cudaStream_t stream) {
  if (G < 1 || C < 1 || n_chunks < 1 || m % G != 0 || n_tokens < 1)
    return cudaErrorInvalidValue;
  const int bn = block_tokens(n_tokens, G);
  if (bn < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(bn + G) * (kTileK + 1) * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const long long n_blocks = ((long long)n_tokens + bn - 1) / bn;
  if (n_blocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(m / G, (unsigned)n_blocks);
  if (scales == nullptr)
    chainmm_rhs_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const int*>(col0), static_cast<T*>(out), n_tokens, k, m,
        n_chunks, G, C, bn);
  else
    chainmm_rhs_q_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scales), static_cast<const int*>(col0),
        static_cast<T*>(out), n_tokens, k, m, n_chunks, G, C, bn);
  return cudaGetLastError();
}

// -- the bf16 tensor-core body ---------------------------------------------

constexpr int kMmaBM = 128;       // tokens a block (the mma's M side)
constexpr int kMmaKS = 64;        // stored columns a stage (the contraction)
constexpr int kMmaStages = 3;     // cp.async ring depth
constexpr int kMmaThreads = 256;  // 8 warps

// The warp grid of a (kMmaBM tokens x BR class rows) block tile: WARPS_M x
// WARPS_N warps, each MT m16 tiles of tokens by NT n8 tiles of rows.
template <int BR>
struct ChainMma {
  static constexpr int kWarpsN = BR >= 64 ? 2 : 1;
  static constexpr int kWarpsM = (kMmaThreads / 32) / kWarpsN;
  static constexpr int kWTM = kMmaBM / kWarpsM;  // tokens a warp
  static constexpr int kWTN = BR / kWarpsN;      // class rows a warp
  static constexpr int kMT = kWTM / 16;
  static constexpr int kNT = kWTN / 8;
  static constexpr int kWRows = BR * 8 / kMmaThreads;  // W rows a thread
  static constexpr size_t kSmem =
      (size_t)kMmaStages * (kMmaBM + BR) * kMmaKS * sizeof(__nv_bfloat16);
  static_assert(BR == 32 || BR == 64, "class rows a block");
  static_assert(kWTN % 16 == 0 && kWRows >= 1, "warp tile");
};

// Y[n0 : n0+128, class rows i0 .. i0+BR-1] of class blockIdx.z (n0 =
// 128*blockIdx.x, i0 = BR*blockIdx.y): class row i is row (i % G) of row
// group cls_groups[cls_start[c] + i / G], and every row of the class meets
// stored column j = s*C + c with input column cls_col0[c, s] + c, so the
// tile is one dense product, X gathered at the class's col0 row (N x R,
// R = n_chunks*C) times the class rows' stored values (R contiguous a
// row: the col-major B operand as they lie).  The contraction runs over R
// in stages of kMmaKS: each stage's X (128 x 64, gathered 8 columns at a
// time: C % 8 == 0, so a 16-byte chunk never straddles a chunk of the
// leaf) and W (BR x 64, a fixed row a thread, gathered once) arrive by
// 16-byte cp.async in a ring of kMmaStages; columns past R, tokens past
// N and rows past the class are zero-filled by the copy itself.  Each
// output's sum runs over R in one fixed order.  A block past its class's
// rows returns at once.
template <int BR>
__global__ void __launch_bounds__(kMmaThreads)
    chainmm_rhs_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           const int* __restrict__ cls_col0,
                           const int* __restrict__ cls_groups,
                           const int* __restrict__ cls_start,
                           __nv_bfloat16* __restrict__ out, int n_tokens,
                           int k, int m, int n_chunks, int G, int C) {
  using S = ChainMma<BR>;
  using mma_bf16::swz;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ws = xs + kMmaStages * kMmaBM * kMmaKS;

  const int cls = blockIdx.z;
  const int first = cls_start[cls];
  const int rows = (cls_start[cls + 1] - first) * G;  // the class's rows
  const int i0 = blockIdx.y * BR;
  if (i0 >= rows) return;  // the whole block: a smaller class
  const int n0 = blockIdx.x * kMmaBM;
  const int len = n_chunks * C;  // R, stored columns of a row
  const int n_steps = (len + kMmaKS - 1) / kMmaKS;
  const int* cols = cls_col0 + (long long)cls * n_chunks;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % S::kWarpsM;
  const int wn = warp / S::kWarpsM;

  // this thread's 16-byte chunk jc of every staged row (X and W alike), and
  // its W rows: class rows i0 + tid/8 + 32*it, gathered once
  const int jc = tid & 7;
  const __nv_bfloat16* w_src[S::kWRows];
  bool w_ok[S::kWRows];
#pragma unroll
  for (int it = 0; it < S::kWRows; ++it) {
    const int ci = i0 + (tid >> 3) + it * (kMmaThreads / 8);
    w_ok[it] = ci < rows;
    const long long row =
        w_ok[it] ? (long long)cls_groups[first + ci / G] * G + ci % G : 0;
    w_src[it] = w + row * len + jc * 8;
  }

  auto load_stage = [&](int step, int slot) {
    __nv_bfloat16* xd = xs + slot * kMmaBM * kMmaKS;
    __nv_bfloat16* wd = ws + slot * BR * kMmaKS;
    const int kk = step * kMmaKS + jc * 8;
    const bool k_in = kk < len;
    int x_col = 0;
    if (k_in) {
      const int s = kk / C;
      x_col = cols[s] + (kk - s * C);
    }
#pragma unroll
    for (int r = tid >> 3; r < kMmaBM; r += kMmaThreads / 8) {
      const int n = n0 + r;
      const bool ok = k_in && n < n_tokens;
      const __nv_bfloat16* src = ok ? x + (long long)n * k + x_col : x;
      mma_bf16::cp_async16(xd + swz<8>(r, jc), src, ok);
    }
#pragma unroll
    for (int it = 0; it < S::kWRows; ++it) {
      const int r = (tid >> 3) + it * (kMmaThreads / 8);
      const bool ok = k_in && w_ok[it];
      const __nv_bfloat16* src = ok ? w_src[it] + step * kMmaKS : w;
      mma_bf16::cp_async16(wd + swz<8>(r, jc), src, ok);
    }
  };

  float acc[S::kMT][S::kNT][4];
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int t = 0; t < S::kNT; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][t][q] = 0.0f;

#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < n_steps) load_stage(st, st);
    mma_bf16::cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    // stage `step` has landed, and every warp is done with the slot the
    // next load overwrites (the one computed last iteration)
    mma_bf16::cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    const int next = step + kMmaStages - 1;
    if (next < n_steps) load_stage(next, next % kMmaStages);
    mma_bf16::cp_async_commit();
    const int slot = step % kMmaStages;
    const __nv_bfloat16* xt = xs + slot * kMmaBM * kMmaKS;
    const __nv_bfloat16* wt = ws + slot * BR * kMmaKS;
#pragma unroll
    for (int ks = 0; ks < kMmaKS / 16; ++ks) {
      uint32_t a[S::kMT][4];
#pragma unroll
      for (int i = 0; i < S::kMT; ++i) {
        const int r = wm * S::kWTM + i * 16 + (lane & 15);
        mma_bf16::ldmatrix_x4(a[i], xt + swz<8>(r, ks * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int t = 0; t < S::kNT / 2; ++t) {
        // class rows t*16 .. +15 of the warp's: matrices (rows 0-7, k
        // 0-7), (rows 0-7, k 8-15), (rows 8-15, k 0-7), (rows 8-15, k
        // 8-15) = b0, b1 of n8 tile 2t and b0, b1 of tile 2t+1
        uint32_t b[4];
        const int r = wn * S::kWTN + t * 16 + (lane & 7) + ((lane >> 4) << 3);
        mma_bf16::ldmatrix_x4(b, wt + swz<8>(r, ks * 2 + ((lane >> 3) & 1)));
#pragma unroll
        for (int i = 0; i < S::kMT; ++i) {
          mma_bf16::mma_16816(acc[i][2 * t], a[i], b[0], b[1]);
          mma_bf16::mma_16816(acc[i][2 * t + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  mma_bf16::cp_async_wait<0>();

  // c0, c1 at (token lane/4, class rows 2*(lane%4) + {0, 1}), c2, c3 eight
  // tokens further: an n8 tile's eight class rows are eight consecutive
  // rows of one row group (G % 8 == 0), so the four lanes of a token write
  // 16 contiguous bytes of Y, one bf16x2 store each
#pragma unroll
  for (int t = 0; t < S::kNT; ++t) {
    const int ci = i0 + wn * S::kWTN + t * 8 + (lane & 3) * 2;
    if (ci >= rows) continue;
    const int row = cls_groups[first + ci / G] * G + ci % G;
#pragma unroll
    for (int i = 0; i < S::kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + wm * S::kWTM + i * 16 + (lane >> 2) + h * 8;
        if (n >= n_tokens) continue;
        *reinterpret_cast<uint32_t*>(out + (long long)n * m + row) =
            mma_bf16::pack_bf16x2(acc[i][t][2 * h], acc[i][t][2 * h + 1]);
      }
  }
}

template <int BR>
cudaError_t launch_mma_rows(const void* x, const void* w,
                            const void* cls_col0, const void* cls_groups,
                            const void* cls_start, void* out, int n_tokens,
                            int k, int m, int n_chunks, int G, int C,
                            int n_classes, int max_groups,
                            cudaStream_t stream) {
  using S = ChainMma<BR>;
  const auto kernel = chainmm_rhs_mma_kernel<BR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_tokens + kMmaBM - 1) / kMmaBM,
                  (max_groups * G + BR - 1) / BR, n_classes);
  kernel<<<grid, kMmaThreads, S::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const int*>(cls_col0),
      static_cast<const int*>(cls_groups), static_cast<const int*>(cls_start),
      static_cast<__nv_bfloat16*>(out), n_tokens, k, m, n_chunks, G, C);
  return cudaGetLastError();
}

// The mma body: bf16 only, G, C and K multiples of 8, x and w 16-byte
// aligned, tile_rows 32 or 64 (kernels/chainmm.py:chain_rhs_tile_rows),
// at most 65535 classes and tiles a side; anything else is refused.
cudaError_t launch_mma(const void* x, const void* w, const void* cls_col0,
                       const void* cls_groups, const void* cls_start,
                       void* out, int n_tokens, int k, int m, int n_chunks,
                       int G, int C, int n_classes, int max_groups,
                       int tile_rows, cudaStream_t stream) {
  if (n_tokens < 1 || n_chunks < 1 || G < 8 || G % 8 != 0 || m % G != 0 ||
      C < 8 || C % 8 != 0 || k % 8 != 0 || n_classes < 1 ||
      n_classes > 65535 || max_groups < 1 || !mma_bf16::aligned16(x) ||
      !mma_bf16::aligned16(w) ||
      ((long long)n_tokens + kMmaBM - 1) / kMmaBM > 2147483647LL ||
      ((long long)max_groups * G + tile_rows - 1) / tile_rows > 65535 ||
      (long long)n_chunks * C > 2147483647LL - kMmaKS)
    return cudaErrorInvalidValue;
  if (tile_rows == 32)
    return launch_mma_rows<32>(x, w, cls_col0, cls_groups, cls_start, out,
                               n_tokens, k, m, n_chunks, G, C, n_classes,
                               max_groups, stream);
  if (tile_rows == 64)
    return launch_mma_rows<64>(x, w, cls_col0, cls_groups, cls_start, out,
                               n_tokens, k, m, n_chunks, G, C, n_classes,
                               max_groups, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out all of it).  x (N, K),
// w (M, n_chunks*C), col0 (M/G, n_chunks) int32, out (N, M).  path: 0 the
// FMA body (reads col0), 1 the bf16 tensor-core body (the caller's choice,
// kernels/chainmm.py:chain_rhs_path), which reads the row-group classes
// instead (cls_col0 (n_classes, n_chunks), cls_groups (M/G,), cls_start
// (n_classes + 1,), int32; max_groups the largest class's row groups) and
// takes tile_rows class rows a block (kernels/chainmm.py:
// chain_rhs_tile_rows).  The FMA body ignores the classes.  Returns the
// cudaError_t of the launch.
extern "C" int chainmm_rhs_launch(int dtype, const void* x, const void* w,
                                  const void* col0, const void* cls_col0,
                                  const void* cls_groups,
                                  const void* cls_start, void* out,
                                  int n_tokens, int k, int m, int n_chunks,
                                  int G, int C, int n_classes,
                                  int max_groups, int path, int tile_rows,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(x, w, cls_col0, cls_groups, cls_start, out,
                           n_tokens, k, m, n_chunks, G, C, n_classes,
                           max_groups, tile_rows, s);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(x, w, nullptr, col0, out, n_tokens, k, m,
                              n_chunks, G, C, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, nullptr, col0, out, n_tokens, k,
                                      m, n_chunks, G, C, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 entry point: q (M, n_chunks*C) int8 and scales (M/G, n_chunks)
// float32 in place of w; x and out of dtype as above.  Returns the
// cudaError_t of the launch.
extern "C" int chainmm_rhs_q_launch(int dtype, const void* x, const void* q,
                                    const void* scales, const void* col0,
                                    void* out, int n_tokens, int k, int m,
                                    int n_chunks, int G, int C,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scales == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(x, q, scales, col0, out, n_tokens, k, m,
                              n_chunks, G, C, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, q, scales, col0, out, n_tokens, k,
                                      m, n_chunks, G, C, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* chainmm_rhs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
