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
// What bounds it on an H100.  At a training step of tinyllama-1.1b under
// the hierarchical-block plan (4096 tokens, bf16, an eighth of each matrix
// stored) it reads g and x once and does 2*N*M*nnz_row operations: bytes
// bound wq/wo and wk/wv, the tensor cores' operations gate/up and down.
//
// The design: one block owns the G x CT outputs of one row group and one
// slice of CT consecutive stored columns of its row (CT spans chunks:
// with a leaf of 8 x 8 a block holds up to 256 columns, 32 chunks, where
// the RBGP4 kernel's block holds one chunk), keeps them in registers (up
// to eight a thread) and walks all N tokens in tiles of kBlockTokens,
// staging g[n-tile, rg*G : rg*G+G] and the gathered x[n-tile, columns of
// the slice] in shared memory (converted to f32), then multiplying them
// with FMAs on the CUDA cores.  CT is halved while the launch would have
// fewer than two blocks an SM (wk/wv: 32 row groups).  No sum crosses
// blocks and there are no atomics, so the order of every sum is fixed and
// a rerun gives the same bits.  The ragged token edge and the row's last
// slice are masked.  Tensor cores (tokens as the contraction; a leaf of
// 8 x 8 pads to wgmma's 16-wide minimum), TMA and a ring of stages come
// with a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (g, x and dW all of it).  g (N, M),
// x (N, K), col0 (M/G, n_chunks) int32, dW (M, n_chunks*C).  Returns the
// cudaError_t of the launch.
extern "C" int chain_sddmm_rhs_launch(int dtype, const void* g, const void* x,
                                      const void* col0, void* dw,
                                      int n_tokens, int k, int m,
                                      int n_chunks, int G, int C,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
