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
// What the design does about it.  The N columns are cut into n_slices
// slices, chosen per launch so that the grid has about eight blocks for
// each of the card's SMs (read from the device); a block owns the G x cs
// outputs of one (row group, slot, column slice cs of C) for one slice of
// N.  Its threads split those outputs into sub-tiles of GT x CT (GT, CT:
// the largest powers of two up to 8 dividing G and cs) and give each
// sub-tile nl lanes; a lane walks the slice's columns lane, lane + nl,
// ..., loading its GT rows of g and CT rows of x straight from device
// memory (coalesced along N: neighbouring lanes read neighbouring
// columns) and doing GT*CT FMAs into f32 registers.  The
// lanes' sums are added by a fixed tree of warp shuffles and, across
// warps, in shared memory in warp order.  With one slice the block writes
// dW; with more it writes f32 partial sums to a workspace the caller
// allocates (n_slices, M, n_chunks*C), and a second kernel in this file
// adds the slices in slice order and writes dW.  No atomics: the order of
// every sum depends only on the shapes, so a rerun gives the same bits.
// Tensor cores (mma.sync with N as the contraction), TMA and a ring are
// work for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// contiguous; `part` may be null when rbgp4_sddmm_slices gives 1.  Returns
// the cudaError_t of the launches.
extern "C" int rbgp4_sddmm_launch(int dtype, const void* g, const void* x,
                                  const void* col0, void* dw, void* part,
                                  int n_cols, int m, int n_chunks, int G,
                                  int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
