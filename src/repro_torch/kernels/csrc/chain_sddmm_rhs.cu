// chain_sddmm_rhs for Hopper (sm_90a): the weight gradient of a deep-chain
// projection in its blocked-CSR storage, dW = pack(g^T . x), token-major,
// with no transposes.
//
// Replaces the Pallas TPU kernel repro/kernels/chainmm.py:chain_sddmm_rhs
// (_chain_sddmm_kernel): dW computed only at the chain mask's non-zeros.
//
// What it computes.  g (N, M) is the cotangent of Y, x (N, K) the
// projection's input, both token-major.  Row rg*G + gi of row group rg and
// stored column j = s*C + c hold
//   dW[rg*G + gi, j] = sum_n g[n, rg*G + gi] * x[n, col0[rg, s] + c],
// where col0 (M/G, n_chunks) is the layer's forward table (the one
// chainmm_rhs reads; see its note for why a chain is one table).  Sums are
// f32 whatever the input type; dW is written in g's type.
//
// Two device bodies.  Which one a launch takes is a fixed function of
// dtype and shape, chosen by the caller (kernels/chainmm.py:
// chain_sddmm_path) and passed as `path`, with the tensor-core body's
// token-slice plan (kernels/chainmm.py:chain_sddmm_mma_plan); the
// launcher refuses a shape or plan the chosen body cannot take, and
// nothing falls back from one body to the other.
//
// 1. The bf16 tensor-core body, chain_sddmm_rhs_mma_kernel and
// chain_sddmm_rhs_sum_kernel (path 1): bfloat16 at N >= 16 tokens with G,
// C and K multiples of 8, every dW launch of a training step.  It works
// over row-group classes (kernels/rbgp4mm.py:RowGroupClasses): the row
// groups whose col0 rows are equal.  The complete 4x4 head factor and the
// complete leaf give whole sets of row groups one column set, so a
// class's rows together are one dense product, dW[class rows] =
// g[:, class rows]^T . x[:, class columns].  tinyllama-1.1b under the
// hierarchical-block plan (forward tables, rows x stored columns a class):
// wq/wo 32 classes of 64 x 256, wk/wv 8 of 32 x 256, gate/up 8 of 704 x
// 256, down 8 of 256 x 704.
//
// What bounds it on an H100.  At a training step (N = 4096, bf16) a
// layer's seven dW launches do 2 * 4096 * 5.51e6 = 45.1 GFLOP (5.51 M
// stored values), 0.046 ms at the 989 TFLOP/s bf16 dense peak, and read
// g and x once (4096 tokens by 17,920 columns each, summed over the
// seven) and write dW: 0.305 GB, 0.091 ms at 3.35 TB/s, so bytes bound
// it.  What this design meets first is L2: a block stages, for each
// 32-token stage, a 32 x 64 tile of g and one of x (8 KB) for 32 x 64 x
// 64 products, so the layer reads (tiles) * N * 128 * 2 B = (2 * 128 + 2
// * 32 + 2 * 352 + 352) MiB = 1.44 GB from L2 (plus the slices' f32
// partial sums, 6.3 MB for each of wq and wo and 2.4 MB for each of wk
// and wv, written and read again), about 0.25-0.3 ms at the 5-6 TB/s an
// H100's L2 gives.  The FMA body below re-gathers x for every row group
// and every 32 tokens.
//
// What the design does about it.  A block owns one tile of one class: 64
// of the class's stored rows (kMmaTile; its row groups' G consecutive g
// columns each, rows past the class zero-filled) by 64 stored columns of
// the class's row (its chunks' C consecutive x columns each, columns past
// n_chunks * C zero-filled), over one token slice.  Tokens are the
// contraction: each 32-token stage brings g[n, the tile's rows] and
// x[n, the tile's columns] by 16-byte cp.async into a ring of kMmaStages
// = 4, rows XOR-swizzled by 16-byte chunk (mma_bf16.cuh), two k16 steps a
// stage.  Each thread copies one fixed 16-byte chunk of each staged
// token row (8 g columns of one row group, 8 x columns of one chunk: G %
// 8 == C % 8 == 0), so the gather through the class tables is computed
// once a block, not once a stage.  The 4 warps split the tile 2 x 2, 32 x
// 32 each; ldmatrix.trans turns the token-major g tile into the row-major
// A = g^T fragment and the token-major x tile into the col-major B = x
// fragment, and mma.sync m16n8k16 adds bf16 products in f32.  Nothing is
// added across warps or blocks inside a slice.  The token range is cut
// into slices (kernels/rbgp4mm.py:token_slices) so that the grid reaches
// two waves on the card's SMs: at N = 4096, wq/wo (128 blocks) into 3
// slices of 1376 tokens, wk/wv (32 blocks) into 9 of 480; gate/up and
// down (352 blocks each) run uncut.  With one slice a block writes dW in
// bf16; with more it writes f32 partial sums to a workspace (n_slices, M,
// n_chunks*C) the wrapper allocates, and chain_sddmm_rhs_sum_kernel adds
// the slices in slice order and writes dW.  No atomics: every sum's order
// is fixed by the shapes, so a rerun gives the same bits.  Every class is
// given the row tiles of the largest (blockIdx.y); a block past its
// class's rows returns at once (none in tinyllama's layouts, whose
// classes are all one size).
//
// Refused (launcher): float32, G, C or K not a multiple of 8, g or x not
// 16-byte aligned (the wrapper checks first and raises), a plan whose
// slices do not cover the tokens exactly in whole stages, more than 65535
// (class, slice) pairs or tiles a side, several slices without a
// workspace.
//
// 2. The FMA body, chain_sddmm_rhs_kernel (path 0): float32 (TF32 stays
// off), bf16 below 16 tokens, and any G and C (the small test chains'
// G = C = 1 and 2).  One block owns the G x CT outputs of one row group
// and one slice of CT consecutive stored columns of its row (CT spans
// chunks), keeps them in registers (up to eight a thread) and walks all N
// tokens in tiles of kBlockTokens, staging g[n-tile, rg*G : rg*G+G] and
// the gathered x[n-tile, columns of the slice] in shared memory
// (converted to f32), then multiplying them with FMAs on the CUDA cores.
// CT is halved while the launch would have fewer than two blocks an SM.
// No sum crosses blocks and there are no atomics, so the order of every
// sum is fixed and a rerun gives the same bits.  The ragged token edge
// and the row's last slice are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAccPerThread = 8;   // G * CT <= kThreads * kAccPerThread
constexpr int kBlockTokens = 32;   // tokens staged per pass
constexpr int kMinBlocks = 264;    // two blocks for each of 132 SMs

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

// The G x CT outputs of row group blockIdx.x, column slice blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    chain_sddmm_rhs_kernel(const T* __restrict__ g, const T* __restrict__ x,
                           const int* __restrict__ col0, T* __restrict__ dw,
                           int n_tokens, int k, int m, int n_chunks, int G,
                           int C, int ct) {
  extern __shared__ float smem[];
  float* gs = smem;                     // (kBlockTokens, G)
  float* xs = smem + kBlockTokens * G;  // (kBlockTokens, ct)

  const int rg = blockIdx.x;            // row group: rows rg*G .. +G-1
  const int row_len = n_chunks * C;     // stored columns of a row
  const int j0 = blockIdx.y * ct;       // first stored column of the slice
  const int cw = min(ct, row_len - j0); // live columns of the slice
  const int tid = threadIdx.x;
  const int n_out = G * ct;
  const int* cols = col0 + (long long)rg * n_chunks;

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
    // x[n0 : n0+BN, input column of stored column j0 + c]
    for (int i = tid; i < kBlockTokens * ct; i += kThreads) {
      const int r = i / ct;
      const int c = i - r * ct;
      const int n = n0 + r;
      float v = 0.0f;
      if (n < n_tokens && c < cw) {
        const int j = j0 + c;
        const int s = j / C;
        v = to_f32(x[(long long)n * k + cols[s] + (j - s * C)]);
      }
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
      dw[row * row_len + j0 + oc[a]] = from_f32<T>(acc[a]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* g, const void* x, const void* col0, void* dw,
                   int n_tokens, int k, int m, int n_chunks, int G, int C,
                   cudaStream_t stream) {
  if (G < 1 || C < 1 || m % G != 0 || n_chunks < 1 || n_tokens < 1)
    return cudaErrorInvalidValue;
  const int row_len = n_chunks * C;
  // columns a block: all its outputs in the accumulators, its staging in
  // the 48 KB of shared memory a launch gets by default
  int ct = row_len;
  ct = min(ct, kThreads * kAccPerThread / G);
  ct = min(ct, 48 * 1024 / (int)(kBlockTokens * sizeof(float)) - G);
  if (ct < 1) return cudaErrorInvalidValue;
  const int n_groups = m / G;
  while (ct > 32 &&
         (long long)n_groups * ((row_len + ct - 1) / ct) < kMinBlocks)
    ct = (ct + 1) / 2;
  const int n_slices = (row_len + ct - 1) / ct;
  if (n_slices > 65535) return cudaErrorInvalidValue;
  const size_t smem = (size_t)kBlockTokens * (G + ct) * sizeof(float);
  const dim3 grid(n_groups, n_slices);
  chain_sddmm_rhs_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const int*>(col0), static_cast<T*>(dw), n_tokens, k, m,
      n_chunks, G, C, ct);
  return cudaGetLastError();
}

// -- the bf16 tensor-core body ---------------------------------------------

constexpr int kMmaTile = 64;      // class rows and stored columns a block
constexpr int kMmaThreads = 128;  // 4 warps, 2 x 2, each 32 x 32
constexpr int kMmaBK = 32;        // tokens a stage
constexpr int kMmaStages = 4;     // cp.async ring depth
constexpr int kMmaTileElems = kMmaBK * kMmaTile;  // one staged tile
constexpr size_t kMmaSmem =
    (size_t)kMmaStages * 2 * kMmaTileElems * sizeof(__nv_bfloat16);

// The 64 x 64 tile dW[class rows i0 .. i0+63, stored columns j0 .. j0+63]
// of class blockIdx.z % n_classes (i0 = 64*blockIdx.y, j0 = 64*blockIdx.x)
// over the tokens of slice blockIdx.z / n_classes (slice_len of them, the
// last one ragged).  Class row i is row (i % G) of row group
// cls_groups[cls_start[c] + i / G]; stored column j = s*C + c meets input
// column cls_col0[c, s] + c.  With one slice the block writes dW in bf16,
// with more its f32 partial sums to part[slice] for
// chain_sddmm_rhs_sum_kernel.
__global__ void __launch_bounds__(kMmaThreads)
    chain_sddmm_rhs_mma_kernel(const __nv_bfloat16* __restrict__ g,
                               const __nv_bfloat16* __restrict__ x,
                               const int* __restrict__ cls_col0,
                               const int* __restrict__ cls_groups,
                               const int* __restrict__ cls_start,
                               __nv_bfloat16* __restrict__ dw,
                               float* __restrict__ part, int n_tokens, int k,
                               int m, int n_chunks, int G, int C,
                               int n_classes, int slice_len) {
  using mma_bf16::swz;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* xs = gs + kMmaStages * kMmaTileElems;

  const int cls = blockIdx.z % n_classes;
  const int slice = blockIdx.z / n_classes;
  const int first = cls_start[cls];
  const int rows = (cls_start[cls + 1] - first) * G;  // the class's rows
  const int i0 = blockIdx.y * kMmaTile;
  if (i0 >= rows) return;  // the whole block: a smaller class
  const int j0 = blockIdx.x * kMmaTile;
  const int row_len = n_chunks * C;
  const int t0 = slice * slice_len;
  const int t1 = min(n_tokens, t0 + slice_len);
  const int n_steps = (t1 - t0 + kMmaBK - 1) / kMmaBK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;

  // This thread's 16-byte chunk jc of every staged token row, the same in
  // every stage: g columns of class rows i0 + 8*jc .. +7 (one row group:
  // G % 8 == 0) and x columns of stored columns j0 + 8*jc .. +7 (one
  // chunk: C % 8 == 0), gathered through the class tables once.
  const int jc = tid & 7;
  const int gi = i0 + jc * 8;
  const bool g_ok = gi < rows;
  long long g_col = 0;
  if (g_ok) g_col = (long long)cls_groups[first + gi / G] * G + gi % G;
  const int xj = j0 + jc * 8;
  const bool x_ok = xj < row_len;
  int x_col = 0;
  if (x_ok) {
    const int s = xj / C;
    x_col = cls_col0[(long long)cls * n_chunks + s] + (xj - s * C);
  }

  auto load_stage = [&](int step, int slot) {
    __nv_bfloat16* gd = gs + slot * kMmaTileElems;
    __nv_bfloat16* xd = xs + slot * kMmaTileElems;
    const int nb = t0 + step * kMmaBK;
#pragma unroll
    for (int r = tid >> 3; r < kMmaBK; r += kMmaThreads / 8) {
      const int n = nb + r;
      const bool in = n < t1;
      const bool gv = in && g_ok, xv = in && x_ok;
      mma_bf16::cp_async16(gd + swz<8>(r, jc),
                           gv ? g + (long long)n * m + g_col : g, gv);
      mma_bf16::cp_async16(xd + swz<8>(r, jc),
                           xv ? x + (long long)n * k + x_col : x, xv);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][t][q] = 0.0f;

#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < n_steps) load_stage(st, st);
    mma_bf16::cp_async_commit();
  }
  const int q = lane >> 3;  // which 8x8 matrix this lane addresses
  for (int step = 0; step < n_steps; ++step) {
    // stage `step` has landed, and every warp is done with the slot the
    // next load overwrites (the one computed last iteration)
    mma_bf16::cp_async_wait<kMmaStages - 2>();
    __syncthreads();
    const int next = step + kMmaStages - 1;
    if (next < n_steps) load_stage(next, next % kMmaStages);
    mma_bf16::cp_async_commit();
    const int slot = step % kMmaStages;
    const __nv_bfloat16* gt = gs + slot * kMmaTileElems;
    const __nv_bfloat16* xt = xs + slot * kMmaTileElems;
#pragma unroll
    for (int ks = 0; ks < kMmaBK / 16; ++ks) {
      const int tok = ks * 16 + (lane & 7);
      // A = g^T (16 rows x 16 tokens) of m16 tile i: matrices (rows 0-7,
      // tokens 0-7), (rows 8-15, tokens 0-7), (rows 0-7, tokens 8-15),
      // (rows 8-15, tokens 8-15), each read transposed from the
      // token-major tile
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mma_bf16::ldmatrix_x4_trans(
            a[i], gt + swz<8>(tok + ((q >> 1) << 3),
                              wm * 4 + i * 2 + (q & 1)));
#pragma unroll
      for (int tp = 0; tp < 2; ++tp) {
        // B = x (16 tokens x 16 columns): matrices (tokens 0-7, cols
        // 0-7), (tokens 8-15, cols 0-7), (tokens 0-7, cols 8-15), (tokens
        // 8-15, cols 8-15) = b0, b1 of n8 tile 2tp and of tile 2tp+1
        uint32_t b[4];
        mma_bf16::ldmatrix_x4_trans(
            b, xt + swz<8>(tok + ((q & 1) << 3), wn * 4 + 2 * tp + (q >> 1)));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16::mma_16816(acc[i][2 * tp], a[i], b[0], b[1]);
          mma_bf16::mma_16816(acc[i][2 * tp + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  mma_bf16::cp_async_wait<0>();

  // c0, c1 at (row lane/4, columns 2*(lane%4) + {0, 1}), c2, c3 eight rows
  // further; one bf16x2 (or float2) store a pair, into the row's own place
  // in the compact storage
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = i0 + wm * 32 + i * 16 + (lane >> 2) + h * 8;
      if (ci >= rows) continue;
      const long long row = (long long)cls_groups[first + ci / G] * G + ci % G;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = j0 + wn * 32 + t * 8 + (lane & 3) * 2;
        if (j >= row_len) continue;
        const long long idx = row * row_len + j;
        const float v0 = acc[i][t][2 * h], v1 = acc[i][t][2 * h + 1];
        if (part != nullptr)
          *reinterpret_cast<float2*>(
              part + (long long)slice * m * row_len + idx) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(dw + idx) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
}

// dW[i] = the slices' partial sums added in slice order, in bf16.
__global__ void __launch_bounds__(256)
    chain_sddmm_rhs_sum_kernel(const float* __restrict__ part,
                               __nv_bfloat16* __restrict__ dw,
                               long long total, int n_slices) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int z = 0; z < n_slices; ++z) v += part[(long long)z * total + i];
    dw[i] = __float2bfloat16(v);
  }
}

// The mma body: bf16 only, G, C and K multiples of 8, g and x 16-byte
// aligned, a slice plan that covers the tokens exactly (slice_len a
// multiple of kMmaBK, n_slices = ceil(n_tokens / slice_len)) and a
// workspace when there is more than one slice.  Anything else is refused.
cudaError_t launch_mma(const void* g, const void* x, const void* cls_col0,
                       const void* cls_groups, const void* cls_start,
                       void* dw, void* part, int n_tokens, int k, int m,
                       int n_chunks, int G, int C, int n_classes,
                       int max_groups, int n_slices, int slice_len,
                       cudaStream_t stream) {
  if (n_tokens < 1 || n_chunks < 1 || G < 8 || G % 8 != 0 || m % G != 0 ||
      C < 8 || C % 8 != 0 || k % 8 != 0 || n_classes < 1 ||
      max_groups < 1 || !mma_bf16::aligned16(g) || !mma_bf16::aligned16(x) ||
      slice_len < kMmaBK || slice_len % kMmaBK != 0 || n_slices < 1 ||
      (long long)(n_slices - 1) * slice_len >= n_tokens ||
      (long long)n_slices * slice_len < n_tokens ||
      (long long)n_classes * n_slices > 65535 ||
      ((long long)max_groups * G + kMmaTile - 1) / kMmaTile > 65535 ||
      ((long long)n_chunks * C + kMmaTile - 1) / kMmaTile > 65535 ||
      (n_slices > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const auto kernel = chain_sddmm_rhs_mma_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMmaSmem);
  if (err != cudaSuccess) return err;
  const int row_len = n_chunks * C;
  const dim3 grid((row_len + kMmaTile - 1) / kMmaTile,
                  (max_groups * G + kMmaTile - 1) / kMmaTile,
                  n_classes * n_slices);
  kernel<<<grid, kMmaThreads, kMmaSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const int*>(cls_col0), static_cast<const int*>(cls_groups),
      static_cast<const int*>(cls_start), static_cast<__nv_bfloat16*>(dw),
      n_slices > 1 ? static_cast<float*>(part) : nullptr, n_tokens, k, m,
      n_chunks, G, C, n_classes, slice_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_slices == 1) return err;
  const long long total = (long long)m * row_len;
  long long blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  chain_sddmm_rhs_sum_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dw),
      total, n_slices);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (g, x and dW all of it).  g (N, M),
// x (N, K), col0 (M/G, n_chunks) int32, dW (M, n_chunks*C).  path: 0 the
// FMA body (reads col0), 1 the bf16 tensor-core body (the caller's choice,
// kernels/chainmm.py:chain_sddmm_path), which reads the row-group classes
// instead (cls_col0 (n_classes, n_chunks), cls_groups (M/G,), cls_start
// (n_classes + 1,), int32; max_groups the largest class's row groups) and
// takes the caller's plan (kernels/chainmm.py:chain_sddmm_mma_plan):
// n_slices slices of slice_len tokens and `part`, a float32 workspace of
// (n_slices, M, n_chunks*C) when n_slices > 1 (else null).  The FMA body
// ignores the classes and the plan.  Returns the cudaError_t of the
// launch.
extern "C" int chain_sddmm_rhs_launch(int dtype, const void* g, const void* x,
                                      const void* col0, const void* cls_col0,
                                      const void* cls_groups,
                                      const void* cls_start, void* dw,
                                      void* part, int n_tokens, int k, int m,
                                      int n_chunks, int G, int C,
                                      int n_classes, int max_groups,
                                      int path, int n_slices, int slice_len,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(g, x, cls_col0, cls_groups, cls_start, dw, part,
                           n_tokens, k, m, n_chunks, G, C, n_classes,
                           max_groups, n_slices, slice_len, s);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(g, x, col0, dw, n_tokens, k, m, n_chunks, G,
                              C, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(g, x, col0, dw, n_tokens, k, m,
                                      n_chunks, G, C, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* chain_sddmm_rhs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
