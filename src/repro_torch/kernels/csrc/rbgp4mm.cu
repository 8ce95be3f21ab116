// rbgp4mm for Hopper (sm_90a): O = W_s . I, feature-major.
//
// Replaces the Pallas TPU kernel repro/kernels/rbgp4mm.py:rbgp4mm
// (_mm_kernel): the paper's Algorithm 1 as the paper states it, with the
// unfolded convolution input I (K, N) holding features along its rows and
// the B*H*W positions along its columns.  Run on a layer's transposed
// layout over the permuted values it gives dI = W_s^T . dO, as the
// reference's RBGP4Op.matmul VJP does.
//
// What it computes.  W_s is in compact RBGP4 storage, w (M, d_o*d_i*C).
// Output row m = rg*G + g of row group rg and compact slot s read the C
// input rows col0[rg, s] + c (c < C), where the host-built table holds
//   col0[rg, s] = adj_o[o, kk]*TK + adj_i[u, ki]*C
// (the same table rbgp4mm_rhs reads: there it indexes columns of X, here
// rows of I), so
//   O[m, n] = sum_s sum_c w[m, s*C + c] * I[col0[rg, s] + c, n].
// Sums are f32 whatever the input type; O is written in I's type.
//
// What bounds it on an H100.  Bytes, at every layer of VGG19-CIFAR at
// batch 256 (bf16): the forward reads I once (K*N) and writes O once
// (M*N) against 2*M*nnz_row*N operations: 14 to 112 operations a byte,
// under the 295 at which the tensor cores would bound it.  The widest
// layer (64 x 576, N = 262144) moves 0.34 GB, 0.10 ms at 3.35 TB/s, for
// 4.8 GFLOP.  dI on the transposed layouts is bound by bytes too.
//
// This first design is simple and right, not fast.  One block owns the G
// rows of one row group over a tile of columns of N.  Its threads split
// the G rows into subsets of GT rows (GT the largest power of two up to 16
// dividing G), at most eight subsets a block: a row group of more than
// eight subsets is cut into passes of up to eight, one block each (the
// grid's z), each reading the group's input rows again.  Each thread
// holds GT x kCols f32 sums in registers for kCols columns strided by the
// block's column threads, so every load of I is coalesced along N and
// feeds GT FMAs.  The block walks its row group's d_o*d_i slots; for each
// it stages the pass's rows x C weight slice in shared memory as f32,
// transposed so that a thread's GT weights of one input row are
// contiguous (float4 loads, broadcast across the warp), and reads the
// input rows straight from device memory.  No sum crosses blocks.  The
// ragged column edge is masked here, not padded by the caller.  The
// column threads per block (32 to 256) are picked per launch from the
// card's SM count, so that small N still gives about two blocks an SM.
// Any G and C work (GT down to 1 for odd G, C staged in passes of up to
// 64 columns); M/G is at most 65535 (the grid's y).  Tensor cores
// (mma.sync / wgmma with the row group's G rows on the M side), TMA and a
// pipelined ring of input tiles are work for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4;         // columns of N a thread owns
constexpr int kTileC = 64;       // weight columns staged per pass
constexpr int kMaxThreads = 256;
constexpr int kMaxSubs = kMaxThreads / 32;  // row subsets a pass

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

// One (row group blockIdx.y) x (kCols * col_threads columns, tile
// blockIdx.x) tile, over the group's row pass blockIdx.z (a pass: `subs`
// subsets of GT rows).  Thread t: column lane t % col_threads, row subset
// t / col_threads of the pass.
template <typename T, int GT>
__global__ void __launch_bounds__(kMaxThreads)
    rbgp4mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const int* __restrict__ col0, T* __restrict__ out,
                   int n_cols, int m, int n_chunks, int G, int C,
                   int col_threads, int subs) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // (ct, GB): ws[c*GB + r]

  const int rg = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % col_threads;
  const int gsub = tid / col_threads;
  const int GB = subs * GT;                // rows a pass
  const int r0 = blockIdx.z * GB;          // first row of this pass
  const int rows = min(GB, G - r0);        // its rows
  const bool mine = gsub * GT < rows;      // this thread has rows in it
  const long long n0 = (long long)blockIdx.x * kCols * col_threads;
  const long long w_row = (long long)n_chunks * C;  // compact row length
  const int ct = C < kTileC ? C : kTileC;

  long long ncol[kCols];
  bool live[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    ncol[j] = n0 + (long long)j * col_threads + lane;
    live[j] = mine && ncol[j] < n_cols;
  }
  float acc[GT][kCols];
#pragma unroll
  for (int i = 0; i < GT; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

  const T* w_blk = w + ((long long)rg * G + r0) * w_row;
  const int* cols = col0 + (long long)rg * n_chunks;
  for (int s = 0; s < n_chunks; ++s) {
    const int r_base = cols[s];  // input row of slot (s, c = 0)
    for (int c0 = 0; c0 < C; c0 += ct) {
      const int cw = min(ct, C - c0);  // live weight columns in this pass
      __syncthreads();                 // the last pass is done with ws
      for (int i = tid; i < rows * cw; i += blockDim.x) {
        const int r = i / cw;
        const int c = i - r * cw;
        ws[c * GB + r] = to_f32(w_blk[(long long)r * w_row +
                                      (long long)s * C + c0 + c]);
      }
      __syncthreads();
      const T* xr = x + (long long)(r_base + c0) * n_cols;
      const float* wr = ws + gsub * GT;
#pragma unroll 4
      for (int c = 0; c < cw; ++c) {
        float xv[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          xv[j] = live[j] ? to_f32(xr[(long long)c * n_cols + ncol[j]]) : 0.0f;
        const float* wc = wr + c * GB;
        if constexpr (GT % 4 == 0) {
#pragma unroll
          for (int q = 0; q < GT / 4; ++q) {
            const float4 w4 = reinterpret_cast<const float4*>(wc)[q];
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
              acc[4 * q + 0][j] = fmaf(w4.x, xv[j], acc[4 * q + 0][j]);
              acc[4 * q + 1][j] = fmaf(w4.y, xv[j], acc[4 * q + 1][j]);
              acc[4 * q + 2][j] = fmaf(w4.z, xv[j], acc[4 * q + 2][j]);
              acc[4 * q + 3][j] = fmaf(w4.w, xv[j], acc[4 * q + 3][j]);
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < GT; ++i) {
            const float wv = wc[i];
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              acc[i][j] = fmaf(wv, xv[j], acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < GT; ++i) {
    const long long row = (long long)rg * G + r0 + gsub * GT + i;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (live[j]) out[row * n_cols + ncol[j]] = from_f32<T>(acc[i][j]);
  }
}

// GT: the largest power of two up to 16 dividing G.
int rows_per_thread(int G) {
  int gt = 16;
  while (G % gt != 0) gt /= 2;
  return gt;
}

// The card's SM count (the current device's).
int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return sms > 0 ? sms : 1;
}

template <typename T, int GT>
cudaError_t launch_gt(const T* x, const T* w, const int* col0, T* out,
                      int n_cols, int m, int n_chunks, int G, int C,
                      cudaStream_t stream) {
  // row subsets a pass: the group's G/GT in as few passes of up to
  // kMaxSubs as there can be, spread evenly
  const int n_sub = G / GT;
  const int passes = (n_sub + kMaxSubs - 1) / kMaxSubs;
  const int subs = (n_sub + passes - 1) / passes;
  // column threads: the most (up to 256 threads a block) that still give
  // about two blocks an SM; at least one warp
  int col_threads = kMaxThreads / subs;
  const long long groups = m / G;
  auto tiles_of = [&](int ct) {
    return (n_cols + (long long)kCols * ct - 1) / ((long long)kCols * ct);
  };
  const long long want = 2LL * sm_count();
  while (col_threads > 32 &&
         tiles_of(col_threads) * groups * passes < want)
    col_threads /= 2;
  const long long tiles = tiles_of(col_threads);
  if (tiles > 2147483647LL || groups > 65535) return cudaErrorInvalidValue;
  const int ct = C < kTileC ? C : kTileC;
  const size_t smem = (size_t)ct * subs * GT * sizeof(float);
  const dim3 grid((unsigned)tiles, (unsigned)groups, (unsigned)passes);
  rbgp4mm_kernel<T, GT><<<grid, subs * col_threads, smem, stream>>>(
      x, w, col0, out, n_cols, m, n_chunks, G, C, col_threads, subs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* col0, void* out,
                   int n_cols, int m, int n_chunks, int G, int C,
                   cudaStream_t stream) {
  if (G < 1 || C < 1 || m % G != 0 || n_chunks < 1 || n_cols < 1)
    return cudaErrorInvalidValue;
  const int gt = rows_per_thread(G);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const int* cp = static_cast<const int*>(col0);
  T* op = static_cast<T*>(out);
  switch (gt) {
    case 16:
      return launch_gt<T, 16>(xp, wp, cp, op, n_cols, m, n_chunks, G, C,
                              stream);
    case 8:
      return launch_gt<T, 8>(xp, wp, cp, op, n_cols, m, n_chunks, G, C,
                             stream);
    case 4:
      return launch_gt<T, 4>(xp, wp, cp, op, n_cols, m, n_chunks, G, C,
                             stream);
    case 2:
      return launch_gt<T, 2>(xp, wp, cp, op, n_cols, m, n_chunks, G, C,
                             stream);
    default:
      return launch_gt<T, 1>(xp, wp, cp, op, n_cols, m, n_chunks, G, C,
                             stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out all of it).  x (K, N),
// w (M, n_chunks*C), col0 (M/G, n_chunks) int32, out (M, N), all
// contiguous.  Returns the cudaError_t of the launch.
extern "C" int rbgp4mm_launch(int dtype, const void* x, const void* w,
                              const void* col0, void* out, int n_cols, int m,
                              int n_chunks, int G, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, w, col0, out, n_cols, m, n_chunks, G, C, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, col0, out, n_cols, m, n_chunks,
                                      G, C, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rbgp4mm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
