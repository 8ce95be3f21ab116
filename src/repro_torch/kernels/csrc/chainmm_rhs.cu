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
// What bounds it on an H100.  tinyllama-1.1b under the hierarchical-block
// plan (0.875, leaf G x C = 8 x 8 for wq/wo/wk/wv, 16 x 32 for gate/up,
// 32 x 16 for down) stores an eighth of each matrix: at decode (8 token
// rows) reading W bounds every launch (2 bytes a value, 8 products each);
// at a training step's 4096 rows the products' operations do, on the
// tensor cores' rate.  This design runs on the CUDA cores, two
// shared-memory loads per FMA, so it stays far from either bound.
//
// The design: one block computes a (BN tokens x G rows) tile of one row
// group.  Where the RBGP4 kernel stages one chunk of C columns per pass,
// this one walks the row's stored columns in passes of kTileK = 64,
// gathering the input column of each through col0 (a pass spans
// 64 / C chunks: at C = 8, eight), so a small leaf still gives 64 FMAs
// an output between two barriers.  Each pass stages the (BN x 64) gathered
// inputs and the (G x 64) weights in shared memory (converted to f32);
// each thread holds up to four outputs in registers; no sum crosses
// blocks, so the order of every sum is fixed.  BN is a power of two
// covering the tokens, at most 128 and at most 1024 / G.  The ragged token
// edge and the row's last pass are masked with zeros.  Any C works, and
// any G up to 128 (a larger G is refused: its staging would pass the 48 KB
// of shared memory a launch gets by default).  G = C = 1 (a chain with no
// trailing complete factor) is right and slow: a block then holds one row
// for 128 tokens, and each stored value is one gathered input column.
// Tensor cores need a padded tile (a leaf of 8 x 8 is below wgmma's
// 16-wide minimum): this version stays on FMAs; TMA, a ring of stages and
// register tiles come later.
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out all of it).  x (N, K),
// w (M, n_chunks*C), col0 (M/G, n_chunks) int32, out (N, M).  Returns the
// cudaError_t of the launch.
extern "C" int chainmm_rhs_launch(int dtype, const void* x, const void* w,
                                  const void* col0, void* out, int n_tokens,
                                  int k, int m, int n_chunks, int G, int C,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
