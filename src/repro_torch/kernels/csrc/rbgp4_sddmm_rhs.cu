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
// What bounds it on an H100.  At a training step of tinyllama-1.1b (4096
// tokens, bf16) it reads g and x once (tens of MB) and does
// 2*N*M*nnz_row operations: bytes bound wq/wo (about 11 us) and wk/wv
// (about 6 us), the tensor cores' operations bound gate/up and down
// (about 24 us).
//
// This first design is simple and right, not fast: one block owns the
// G x CT outputs of one (row group, slot) pair (CT = C, or a slice of it
// when G*C would not fit the threads' accumulators), keeps them in
// registers, and walks all N tokens in tiles of kBlockTokens, staging
// g[n-tile, rg*G : rg*G+G] and x[n-tile, col0[rg,s]+c0 : +CT] in shared
// memory (converted to f32) and multiplying them with FMAs on the CUDA
// cores.  No sum crosses blocks and there are no atomics, so the order of
// every sum is fixed and a rerun gives the same bits.  The ragged token
// edge is masked here.  What it leaves for later: the tensor cores
// (mma.sync / wgmma with tokens as the contraction), TMA and a pipelined
// ring, and more blocks for thin layers: (M/G) * d_o * d_i blocks is only
// 64 for wk/wv, on 132 SMs.
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
// FMA design above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// The body of both entry kernels below: the G x CT outputs of row group
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

// dtype: 0 = float32, 1 = bfloat16 (g, x and dW all of it).  Returns the
// cudaError_t of the launch.
extern "C" int rbgp4_sddmm_rhs_launch(int dtype, const void* g, const void* x,
                                      const void* col0, void* dw,
                                      int n_tokens, int k, int m,
                                      int n_chunks, int G, int C,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
