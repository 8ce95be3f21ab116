// rbgp4_sddmm for Hopper (sm_90a): compact dW = pack(dO . I^T),
// feature-major.
//
// Replaces the Pallas TPU kernel repro/kernels/rbgp4mm.py:rbgp4_sddmm
// (_sddmm_kernel): the weight gradient of the paper's feature-major
// product O = W_s . I, computed only at the mask's non-zeros.
//
// What it computes.  g (M, N) is the cotangent of O, x (K, N) the
// product's input, both with features along the rows.  Output row
// m = rg*G + gi of row group rg and compact slot s hold the C values
//   dW[m, s*C + c] = sum_n g[m, n] * x[col0[rg, s] + c, n],   c < C,
// where col0 is the layer's forward table (the one rbgp4mm reads).  Sums
// are f32 whatever the input type; dW is written in g's type.
//
// What bounds it on an H100.  Bytes, at every layer of VGG19-CIFAR at
// batch 256 (bf16): it reads g and x once and writes the small compact
// dW, against 2*M*nnz_row*N operations (14 to 112 a byte).  The hazard is
// the shape: the contraction runs over up to N = 262144 columns and there
// are few outputs, (M/G)*d_o*d_i = 72 (row group, slot) pairs for the
// 64 x 576 layer, on an H100 SXM's 132 SMs.
//
// Two device bodies.  Which one a launch takes is a fixed function of
// dtype and shape, chosen by the caller (kernels/rbgp4mm.py:
// fm_sddmm_path) and passed as `path`, with the tensor-core body's plan
// (block columns, token slices: kernels/rbgp4mm.py:fm_sddmm_plan, a pure
// function of the shapes and the card's SM count); the launcher refuses
// a shape or plan the chosen body cannot take, and nothing falls back
// from one body to the other.
//
// 1. The bf16 tensor-core body, rbgp4_sddmm_mma_kernel<BC> (path 1):
// bfloat16 at N >= 16, N a multiple of 8 (every row of g and x then
// starts 16-byte aligned), G a multiple of 16 and C of 8: every dW launch
// of a VGG19-CIFAR pass at batch 256 (G = 16, C = 8-64, 18 slots).
//
// What bounds it on an H100: the bytes above.  This design meets L2
// first, as rbgp4mm's tensor-core body does: a block gathers, for 16 rows
// of a row group, the input rows of its compact columns, which serve only
// those 16 rows: M*K*N/32 bytes of L2 reads a layer (3.2 GB a VGG19
// pass, about 0.6 ms at the 5-6 TB/s an H100's L2 gives), plus g once for
// each block of columns of a row.
//
// What the design does about it.  N is the mma's contraction.  A block
// owns the 16 x BC outputs dW[r0 : r0+16, j0 : j0+BC] (16 rows of a row
// group, BC compact columns of its row: several slots where C < BC, so
// one staged g tile serves them all) over one token slice.  At the start
// it writes a table of the input row each of its columns reads,
// col0[rg, j/C] + j%C (-1 past the row), into shared memory.  Each stage
// brings kMmaBK = 64 tokens of g[r0 : r0+16, n] and of the gathered rows
// of x by 16-byte cp.async into a ring of kMmaStages (rows XOR-swizzled
// by 16-byte chunk, mma_bf16.cuh).  Both tiles are feature-major, rows
// contiguous along N: plain ldmatrix gives the row-major A = g fragment
// and, the x rows being the columns of B, the col-major B = x^T fragment,
// so nothing is transposed.  The BC/32 warps split the columns, 32 each
// (two ldmatrix.x4 and four mma.sync m16n8k16 a k16 step against one A
// fragment), so no sum crosses warps.  At the end each thread writes 8
// consecutive outputs of a row with one 16-byte store: with one slice dW
// in bf16, with more its f32 partial sums to part[slice] of a workspace
// (n_slices, M, n_chunks*C) the wrapper allocates, which
// rbgp4_sddmm_reduce_kernel adds in slice order.  The slices (each a
// whole number of stages, the last ragged) bring the grid to two waves of
// blocks on the card's SMs: at 64 x 576, N = 262144, 4 x 2 blocks a slice
// (BC = 128) take 33 slices of 7936 tokens.  No atomics: the order of
// every sum is fixed by the stage and the slices, so a rerun gives the
// same bits.  Columns past the row and tokens past the slice are
// zero-filled by the copy itself (src-size 0).
//
// chip_smoke.py's feature-major sweep timed 64-, 128- and 256-column
// blocks at VGG19-CIFAR's eight layer shapes (NVIDIA H100 80GB HBM3, 700
// W): 256 where one block holds the whole row (C = 8: 144 columns, 0.129
// ms at 64 x 576, N = 262144, against 0.149 at 128), 128 up to 576
// columns, 64 at 1152 (kernels/rbgp4mm.py:fm_sddmm_tile): 1.02 ms a
// VGG19 pass against the FMA body's 4.41.
//
// Build (nvcc -Xptxas -v, sm_90a): 52 to 56 registers, no spills;
// dynamic shared memory max(3 * (16 + BC) * 64 * 2, 16 * (BC + 4) * 4)
// bytes plus the BC-entry column table, 104,448 + 1,024 at BC = 256 (each
// launch sets cudaFuncAttributeMaxDynamicSharedMemorySize).  Refused
// (launcher): float32, G not a multiple of 16, C or N not a multiple of
// 8, g, x or dW not 16-byte aligned (the wrapper checks g and x first and
// raises), block columns outside {64, 128, 256}, a stage other than 64
// tokens, a plan whose slices do not cover the tokens exactly in whole
// stages, more than 65535 slices or column blocks, several slices
// without a workspace.
//
// 2. The FMA body, rbgp4_sddmm_kernel (path 0): float32 (TF32 stays off),
// bf16 below 16 tokens or at N not a multiple of 8, and any G and C.  The
// N columns are cut into n_slices slices, chosen per launch so that the
// grid has about eight blocks for each of the card's SMs (read from the
// device); a block owns the G x cs outputs of one (row group, slot,
// column slice cs of C) for one slice of N.  Its threads split those
// outputs into sub-tiles of GT x CT (GT, CT: the largest powers of two up
// to 8 dividing G and cs) and give each sub-tile nl lanes; a lane walks
// the slice's columns lane, lane + nl, ..., loading its GT rows of g and
// CT rows of x straight from device memory (coalesced along N:
// neighbouring lanes read neighbouring columns) and doing GT*CT FMAs into
// f32 registers.  The lanes' sums are added by a fixed tree of warp
// shuffles and, across warps, in shared memory in warp order.  With one
// slice the block writes dW; with more it writes f32 partial sums to a
// workspace the caller allocates (n_slices, M, n_chunks*C), and
// rbgp4_sddmm_reduce_kernel adds the slices in slice order and writes
// dW.  No atomics: the order of every sum depends only on the shapes, so
// a rerun gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSubTiles = 64;    // sub-tiles a block: at least 4 lanes
constexpr int kBlocksPerSm = 8;     // blocks wanted for each SM
constexpr int kMinSliceCols = 512;

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

// Blocks the grid should have: kBlocksPerSm for each SM of the current
// device.
long long blocks_wanted() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      sms < 1)
    sms = 1;
  return (long long)kBlocksPerSm * sms;
}

int pow2_divisor(int v, int cap) {
  int p = cap;
  while (v % p != 0) p /= 2;
  return p;
}

// The launch shape of one call, a function of the shapes alone.
struct Plan {
  int gt, ct;       // sub-tile of a thread: GT rows x CT columns
  int cs;           // columns of C a block owns (a divisor of C)
  int n_cslices;    // C / cs
  int sub_tiles;    // (G/GT) * (cs/CT)
  int nl;           // lanes a sub-tile (a power of two)
  int n_slices;     // slices of N
  long long slice_len;
};

Plan make_plan(int n_cols, int m, int n_chunks, int G, int C,
               long long wanted) {
  Plan p;
  p.gt = pow2_divisor(G, 8);
  p.cs = C;
  while ((G / p.gt) * (p.cs / pow2_divisor(p.cs, 8)) > kMaxSubTiles &&
         p.cs % 2 == 0)
    p.cs /= 2;
  p.ct = pow2_divisor(p.cs, 8);
  p.n_cslices = C / p.cs;
  p.sub_tiles = (G / p.gt) * (p.cs / p.ct);
  p.nl = 1;
  while (p.nl * 2 * p.sub_tiles <= kThreads) p.nl *= 2;
  const long long base = (long long)(m / G) * n_chunks * p.n_cslices;
  long long want = (wanted + base - 1) / base;
  const long long most = (n_cols + kMinSliceCols - 1) / kMinSliceCols;
  if (want > most) want = most;
  if (want < 1) want = 1;
  p.slice_len = (n_cols + want - 1) / want;
  p.n_slices = (int)((n_cols + p.slice_len - 1) / p.slice_len);
  return p;
}

// One block: row group blockIdx.y, (slot, column slice of C) blockIdx.x,
// slice of N blockIdx.z.  Thread t: lane t % nl of sub-tile t / nl.
template <typename T, int GT, int CT>
__global__ void __launch_bounds__(kThreads)
    rbgp4_sddmm_kernel(const T* __restrict__ g, const T* __restrict__ x,
                       const int* __restrict__ col0, T* __restrict__ dw,
                       float* __restrict__ part, int n_cols, int m,
                       int n_chunks, int G, int C, int cs, int n_cslices,
                       int sub_tiles, int nl, long long slice_len) {
  __shared__ float red[kWarps][GT * CT];

  const int rg = blockIdx.y;
  const int s = blockIdx.x / n_cslices;
  const int c_base = (blockIdx.x % n_cslices) * cs;
  const int tid = threadIdx.x;
  const int lane = tid % nl;
  const int sub = tid / nl;
  const bool active = sub < sub_tiles;
  const int csubs = cs / CT;
  const int gi = active ? sub / csubs : 0;
  const int ci = active ? sub % csubs : 0;
  const long long w_row = (long long)n_chunks * C;

  const T* gr = g + ((long long)rg * G + gi * GT) * n_cols;
  const T* xr =
      x + ((long long)col0[(long long)rg * n_chunks + s] + c_base + ci * CT) *
              n_cols;

  float acc[GT][CT];
#pragma unroll
  for (int i = 0; i < GT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;

  const long long lo = (long long)blockIdx.z * slice_len;
  const long long end = lo + slice_len;
  const long long hi = end < n_cols ? end : (long long)n_cols;
  if (active) {
#pragma unroll 2
    for (long long n = lo + lane; n < hi; n += nl) {
      float gv[GT], xv[CT];
#pragma unroll
      for (int i = 0; i < GT; ++i) gv[i] = to_f32(gr[i * (long long)n_cols + n]);
#pragma unroll
      for (int j = 0; j < CT; ++j) xv[j] = to_f32(xr[j * (long long)n_cols + n]);
#pragma unroll
      for (int i = 0; i < GT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
    }
  }

  // the lanes of a sub-tile: a fixed tree of shuffles within the warp
  const int span = nl < 32 ? nl : 32;
  for (int off = span / 2; off > 0; off /= 2)
#pragma unroll
    for (int i = 0; i < GT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);

  const long long w_off = (long long)s * C + c_base + ci * CT;
  auto store = [&](int i, int j, float v) {
    const long long idx =
        ((long long)rg * G + gi * GT + i) * w_row + w_off + j;
    if (part == nullptr)
      dw[idx] = from_f32<T>(v);
    else
      part[(long long)blockIdx.z * m * w_row + idx] = v;
  };
  if (nl <= 32) {
    if (active && lane == 0)
#pragma unroll
      for (int i = 0; i < GT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) store(i, j, acc[i][j]);
    return;
  }
  // more than a warp a sub-tile: add the warps' sums in warp order
  const int warp = tid / 32;
  if (tid % 32 == 0)
#pragma unroll
    for (int i = 0; i < GT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) red[warp][i * CT + j] = acc[i][j];
  __syncthreads();
  const int per_sub = nl / 32;  // warps a sub-tile
  if (active && lane < GT * CT) {
    const int w0 = sub * per_sub;
    float v = 0.0f;
    for (int k = 0; k < per_sub; ++k) v += red[w0 + k][lane];
    store(lane / CT, lane % CT, v);
  }
}

// dW[i] = sum of the slices' partial sums, in slice order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rbgp4_sddmm_reduce_kernel(const float* __restrict__ part,
                              T* __restrict__ dw, long long total,
                              int n_slices) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int z = 0; z < n_slices; ++z) v += part[(long long)z * total + i];
    dw[i] = from_f32<T>(v);
  }
}

template <typename T, int GT, int CT>
cudaError_t launch_tile(const Plan& p, const T* g, const T* x,
                        const int* col0, T* dw, float* part, int n_cols,
                        int m, int n_chunks, int G, int C,
                        cudaStream_t stream) {
  const dim3 grid((unsigned)(n_chunks * p.n_cslices), (unsigned)(m / G),
                  (unsigned)p.n_slices);
  rbgp4_sddmm_kernel<T, GT, CT><<<grid, kThreads, 0, stream>>>(
      g, x, col0, dw, p.n_slices > 1 ? part : nullptr, n_cols, m, n_chunks,
      G, C, p.cs, p.n_cslices, p.sub_tiles, p.nl, p.slice_len);
  return cudaGetLastError();
}

template <typename T, int GT>
cudaError_t launch_gt(const Plan& p, const T* g, const T* x, const int* col0,
                      T* dw, float* part, int n_cols, int m, int n_chunks,
                      int G, int C, cudaStream_t stream) {
  switch (p.ct) {
    case 8:
      return launch_tile<T, GT, 8>(p, g, x, col0, dw, part, n_cols, m,
                                   n_chunks, G, C, stream);
    case 4:
      return launch_tile<T, GT, 4>(p, g, x, col0, dw, part, n_cols, m,
                                   n_chunks, G, C, stream);
    case 2:
      return launch_tile<T, GT, 2>(p, g, x, col0, dw, part, n_cols, m,
                                   n_chunks, G, C, stream);
    default:
      return launch_tile<T, GT, 1>(p, g, x, col0, dw, part, n_cols, m,
                                   n_chunks, G, C, stream);
  }
}

template <typename T>
cudaError_t launch(const void* g, const void* x, const void* col0, void* dw,
                   void* part, int n_cols, int m, int n_chunks, int G,
                   int C, cudaStream_t stream) {
  if (G < 1 || C < 1 || m % G != 0 || n_chunks < 1 || n_cols < 1)
    return cudaErrorInvalidValue;
  const long long wanted = blocks_wanted();
  const Plan p = make_plan(n_cols, m, n_chunks, G, C, wanted);
  if (p.sub_tiles > kThreads || m / G > 65535 || p.n_slices > 65535 ||
      (long long)n_chunks * p.n_cslices > 2147483647LL ||
      (p.n_slices > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const T* gp = static_cast<const T*>(g);
  const T* xp = static_cast<const T*>(x);
  const int* cp = static_cast<const int*>(col0);
  T* dp = static_cast<T*>(dw);
  float* pp = static_cast<float*>(part);
  cudaError_t err;
  switch (p.gt) {
    case 8:
      err = launch_gt<T, 8>(p, gp, xp, cp, dp, pp, n_cols, m, n_chunks, G, C,
                            stream);
      break;
    case 4:
      err = launch_gt<T, 4>(p, gp, xp, cp, dp, pp, n_cols, m, n_chunks, G, C,
                            stream);
      break;
    case 2:
      err = launch_gt<T, 2>(p, gp, xp, cp, dp, pp, n_cols, m, n_chunks, G, C,
                            stream);
      break;
    default:
      err = launch_gt<T, 1>(p, gp, xp, cp, dp, pp, n_cols, m, n_chunks, G, C,
                            stream);
  }
  if (err != cudaSuccess || p.n_slices == 1) return err;
  const long long total = (long long)m * n_chunks * C;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 4 * wanted) blocks = 4 * wanted;
  rbgp4_sddmm_reduce_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      pp, dp, total, p.n_slices);
  return cudaGetLastError();
}

// -- the bf16 tensor-core body ---------------------------------------------

constexpr int kMmaBK = 64;       // tokens a stage
constexpr int kMmaStages = 3;    // cp.async ring depth

// A block of the tensor-core body: 16 rows by BC compact columns on BC/32
// warps, warp w owning columns 32w .. 32w+31 (four n8 tiles).
template <int BC>
struct SddmmMma {
  static constexpr int kWarps = BC / 32;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kLD = BC + 4;  // f32 pitch of the epilogue's rows
  static constexpr size_t kStage =
      (size_t)(16 + BC) * kMmaBK * sizeof(__nv_bfloat16);
  static constexpr size_t kRing = kMmaStages * kStage;
  static constexpr size_t kRed = (size_t)16 * kLD * sizeof(float);
  // the column table starts past both the ring and the epilogue tile
  static constexpr size_t kTable = kRing > kRed ? kRing : kRed;
  static constexpr size_t kSmem = kTable + BC * sizeof(int);
  static_assert(BC == 64 || BC == 128 || BC == 256, "block columns");
};

// The outputs dW[r0 : r0+16, j0 : j0+BC] of row sub-tile blockIdx.x (r0 =
// 16*blockIdx.x, row group r0 / G) and compact columns j0 = BC*blockIdx.y
// (columns past len = n_chunks*C are neither read nor written) over the
// tokens of slice blockIdx.z (slice_len of them, the last one ragged).
template <int BC>
__global__ void __launch_bounds__(SddmmMma<BC>::kThreads)
    rbgp4_sddmm_mma_kernel(const __nv_bfloat16* __restrict__ g,
                           const __nv_bfloat16* __restrict__ x,
                           const int* __restrict__ col0,
                           __nv_bfloat16* __restrict__ dw,
                           float* __restrict__ part, int n_cols, int m,
                           int n_chunks, int G, int C, int slice_len) {
  using S = SddmmMma<BC>;
  using mma_bf16::swz;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* xs = gs + kMmaStages * 16 * kMmaBK;
  int* xrow = reinterpret_cast<int*>(smem_raw + S::kTable);

  const int r0 = blockIdx.x * 16;
  const int rg = r0 / G;
  const int len = n_chunks * C;
  const int j0 = blockIdx.y * BC;
  const int slice = blockIdx.z;
  const long long t0 = (long long)slice * slice_len;
  const long long t1 = min((long long)n_cols, t0 + slice_len);
  const int n_steps = (int)((t1 - t0 + kMmaBK - 1) / kMmaBK);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int j = tid; j < BC; j += S::kThreads) {
    const int jj = j0 + j;
    int r = -1;
    if (jj < len) {
      const int s = jj / C;
      r = col0[(long long)rg * n_chunks + s] + (jj - s * C);
    }
    xrow[j] = r;
  }
  __syncthreads();

  // stage `step`: tokens t0 + 64*step .. +63 of g's 16 rows and of the
  // block's gathered x rows, 8 chunks a row
  auto load_stage = [&](int step, int slot) {
    __nv_bfloat16* gd = gs + slot * 16 * kMmaBK;
    __nv_bfloat16* xd = xs + slot * BC * kMmaBK;
    const long long nb = t0 + (long long)step * kMmaBK;
    for (int i = tid; i < 16 * 8; i += S::kThreads) {
      const int r = i >> 3, j = i & 7;
      const long long n = nb + j * 8;
      const bool ok = n < t1;
      const __nv_bfloat16* src = ok ? g + (long long)(r0 + r) * n_cols + n : g;
      mma_bf16::cp_async16(gd + swz<8>(r, j), src, ok);
    }
#pragma unroll 4
    for (int i = tid; i < BC * 8; i += S::kThreads) {
      const int r = i >> 3, j = i & 7;
      const long long n = nb + j * 8;
      const int xr = xrow[r];
      const bool ok = n < t1 && xr >= 0;
      const __nv_bfloat16* src = ok ? x + (long long)xr * n_cols + n : x;
      mma_bf16::cp_async16(xd + swz<8>(r, j), src, ok);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
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
    const __nv_bfloat16* gt = gs + slot * 16 * kMmaBK;
    const __nv_bfloat16* xt = xs + slot * BC * kMmaBK;
#pragma unroll
    for (int ks = 0; ks < kMmaBK / 16; ++ks) {
      // A = g (16 rows x 16 tokens): matrices (rows 0-7, tokens 0-7),
      // (rows 8-15, tokens 0-7), (rows 0-7, tokens 8-15), (rows 8-15,
      // tokens 8-15)
      uint32_t a[4];
      mma_bf16::ldmatrix_x4(a, gt + swz<8>(lane & 15, ks * 2 + (lane >> 4)));
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        // B = x^T (16 tokens x 16 columns) of columns 32w + 16u ..:
        // matrices (columns 0-7, tokens 0-7), (columns 0-7, tokens 8-15),
        // (columns 8-15, tokens 0-7), (columns 8-15, tokens 8-15) = b0,
        // b1 of n8 tile 2u and of tile 2u+1
        uint32_t b[4];
        const int r = warp * 32 + u * 16 + (lane & 7) + ((lane >> 4) << 3);
        mma_bf16::ldmatrix_x4(b, xt + swz<8>(r, ks * 2 + ((lane >> 3) & 1)));
        mma_bf16::mma_16816(acc[2 * u], a, b[0], b[1]);
        mma_bf16::mma_16816(acc[2 * u + 1], a, b[2], b[3]);
      }
    }
  }
  mma_bf16::cp_async_wait<0>();
  __syncthreads();  // the ring is reused for the block's sums

  // the 16 x BC f32 tile: c0, c1 at (row lane/4, columns 2*(lane%4) +
  // {0, 1}) of each n8 tile, c2, c3 eight rows further
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = (lane >> 2) + ((q >> 1) << 3);
      const int col = warp * 32 + t * 8 + (lane & 3) * 2 + (q & 1);
      red[row * S::kLD + col] = acc[t][q];
    }
  __syncthreads();
  for (int c = tid; c < 16 * (BC / 8); c += S::kThreads) {
    const int row = c / (BC / 8), c8 = (c % (BC / 8)) * 8;
    if (j0 + c8 >= len) continue;
    const float* v = red + row * S::kLD + c8;
    const long long idx = (long long)(r0 + row) * len + j0 + c8;
    if (part != nullptr) {
      float4* p = reinterpret_cast<float4*>(part + (long long)slice * m * len +
                                            idx);
      p[0] = make_float4(v[0], v[1], v[2], v[3]);
      p[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      *reinterpret_cast<uint4*>(dw + idx) = make_uint4(
          mma_bf16::pack_bf16x2(v[0], v[1]), mma_bf16::pack_bf16x2(v[2], v[3]),
          mma_bf16::pack_bf16x2(v[4], v[5]), mma_bf16::pack_bf16x2(v[6], v[7]));
    }
  }
}

template <int BC>
cudaError_t launch_mma_bc(const void* g, const void* x, const void* col0,
                          void* dw, void* part, int n_cols, int m,
                          int n_chunks, int G, int C, int n_slices,
                          int slice_len, cudaStream_t stream) {
  using S = SddmmMma<BC>;
  const auto kernel = rbgp4_sddmm_mma_kernel<BC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return err;
  const long long len = (long long)n_chunks * C;
  const dim3 grid((unsigned)(m / 16), (unsigned)((len + BC - 1) / BC),
                  (unsigned)n_slices);
  kernel<<<grid, S::kThreads, S::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(col0),
      static_cast<__nv_bfloat16*>(dw),
      n_slices > 1 ? static_cast<float*>(part) : nullptr, n_cols, m,
      n_chunks, G, C, slice_len);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_slices == 1) return err;
  const long long total = (long long)m * len;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 4 * blocks_wanted()) blocks = 4 * blocks_wanted();
  rbgp4_sddmm_reduce_kernel<__nv_bfloat16>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
          static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dw),
          total, n_slices);
  return cudaGetLastError();
}

// The mma body: bf16 only, G a multiple of 16, C of 8, N of 8, g and x
// 16-byte aligned, block_cols in {64, 128, 256}, stage_tokens 64, and a
// slice plan that covers the tokens exactly: slice_len a multiple of 64,
// n_slices = ceil(N / slice_len) up to 65535, a workspace when there is
// more than one slice.  Anything else is refused.
cudaError_t launch_mma(const void* g, const void* x, const void* col0,
                       void* dw, void* part, int n_cols, int m, int n_chunks,
                       int G, int C, int block_cols, int stage_tokens,
                       int n_slices, int slice_len, cudaStream_t stream) {
  if (n_cols < 1 || n_cols % 8 != 0 || n_chunks < 1 || G < 16 ||
      G % 16 != 0 || m % G != 0 || C < 8 || C % 8 != 0 ||
      !mma_bf16::aligned16(g) || !mma_bf16::aligned16(x) ||
      !mma_bf16::aligned16(dw) || stage_tokens != kMmaBK ||
      slice_len < kMmaBK || slice_len % kMmaBK != 0 || n_slices < 1 ||
      n_slices > 65535 || (long long)(n_slices - 1) * slice_len >= n_cols ||
      (long long)n_slices * slice_len < n_cols || block_cols < 64 ||
      ((long long)n_chunks * C + block_cols - 1) / block_cols > 65535 ||
      (n_slices > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  switch (block_cols) {
    case 64:
      return launch_mma_bc<64>(g, x, col0, dw, part, n_cols, m, n_chunks, G,
                               C, n_slices, slice_len, stream);
    case 128:
      return launch_mma_bc<128>(g, x, col0, dw, part, n_cols, m, n_chunks, G,
                                C, n_slices, slice_len, stream);
    case 256:
      return launch_mma_bc<256>(g, x, col0, dw, part, n_cols, m, n_chunks, G,
                                C, n_slices, slice_len, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The number of slices of N a launch at these shapes on the current device
// cuts the contraction into; with more than one, the caller passes a
// float32 workspace of (n_slices, M, n_chunks*C) as `part`.
extern "C" int rbgp4_sddmm_slices(int n_cols, int m, int n_chunks, int G,
                                  int C) {
  if (G < 1 || C < 1 || m % G != 0 || n_chunks < 1 || n_cols < 1) return 1;
  return make_plan(n_cols, m, n_chunks, G, C, blocks_wanted()).n_slices;
}

// dtype: 0 = float32, 1 = bfloat16 (g, x and dW all of it).  g (M, N),
// x (K, N), col0 (M/G, n_chunks) int32, dW (M, n_chunks*C), all
// contiguous.  path: 0 the FMA body, which cuts N by its own plan
// (rbgp4_sddmm_slices: `part` may be null when that gives 1) and ignores
// the plan arguments; 1 the bf16 tensor-core body (the caller's choice,
// kernels/rbgp4mm.py:fm_sddmm_path) with the caller's plan
// (kernels/rbgp4mm.py:fm_sddmm_plan): block_cols compact columns a block,
// stage_tokens tokens a stage, n_slices slices of slice_len tokens, and
// `part`, a float32 workspace of (n_slices, M, n_chunks*C) when n_slices
// > 1.  Returns the cudaError_t of the launches.
extern "C" int rbgp4_sddmm_launch(int dtype, const void* g, const void* x,
                                  const void* col0, void* dw, void* part,
                                  int n_cols, int m, int n_chunks, int G,
                                  int C, int path, int block_cols,
                                  int stage_tokens, int n_slices,
                                  int slice_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(g, x, col0, dw, part, n_cols, m, n_chunks, G, C,
                           block_cols, stage_tokens, n_slices, slice_len, s);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(g, x, col0, dw, part, n_cols, m, n_chunks, G,
                              C, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(g, x, col0, dw, part, n_cols, m,
                                      n_chunks, G, C, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rbgp4_sddmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
