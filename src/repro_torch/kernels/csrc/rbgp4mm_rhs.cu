// rbgp4mm_rhs for Hopper (sm_90a): Y = act(X . W_s^T + b) + r, token-major.
//
// Replaces the Pallas TPU kernel repro/kernels/rbgp4mm.py:rbgp4mm_rhs
// (_mm_rhs_kernel, _rhs_accumulate, _rhs_writeback), with `save_preact`
// (the pre-activation Z = X . W_s^T + b as a second output) and the int8
// `scales` path (has_scales; see the end of this note).  Training runs it
// three ways: the forward of
// every compact projection (with Z where an activation is fused), its
// recompute under activation checkpointing, and dX = gz . W_s as this
// kernel on the layer's transposed layout.
//
// What it computes.  W_s is in compact RBGP4 storage, w (M, d_o*d_i*C).
// Output row m = (o, u, g) is tile-row o, inner group u, row g < G; its
// row group is rg = m / G = o*u_i + u.  Compact slot s = (kk, ki) covers
// the C columns w[m, s*C : (s+1)*C], which multiply the input columns
// col0[rg, s] + c, where the host-built table holds
//   col0[rg, s] = adj_o[o, kk]*TK + adj_i[u, ki]*C.
// The table takes the place of the TPU kernel's scalar-prefetched adj_o
// and its static unroll over adj_i.  Sums are f32 whatever the input type.
//
// What bounds it on an H100.  At decode (8 token rows) every weight is
// read once per step and used for 8 products: about 154 launches and
// 0.48 GB of bf16 weights per step of tinyllama-1.1b, so reading W from
// device memory bounds it (3.35 TB/s).  At prefill (512 rows) the bound is
// still bytes for these shapes, with the tensor cores close behind.  At a
// training step's 4096 rows the forward layouts (G = 16) and the dX
// layouts (G = 64 and 128, C = 16, up to 88 chunks a row) are bound by
// the tensor cores' operations; this design runs on the CUDA cores, two
// shared-memory loads per FMA, so it stays far from that bound.
//
// This first design is simple and right, not fast: one block computes a
// (BN tokens x G rows) tile of one row group, walks the d_o*d_i chunks,
// stages each (BN x C) input slice and (G x C) weight slice in shared
// memory (converted to f32, in passes of at most 64 columns) and
// multiplies them with FMAs on the CUDA cores, each thread holding up to
// four outputs in registers.  The epilogue (bias, Z, activation,
// residual) runs on those registers before the single store of Y (and of
// Z, from the same registers).  No sum crosses blocks.  At G = 128 a
// block holds only BN = 8 tokens, so it reads its 128 weight rows once
// for every 8 tokens: the dX launches re-read W from L2 N/8 times.
// The block's token count BN is picked per launch (block_tokens).  The
// ragged token edge is masked here, not padded by the caller.  Any C and
// any G up to 128 work; a G whose staging needs more than the 48 KB of
// shared memory a launch gets by default is refused.  Tensor cores
// (mma.sync / wgmma with tokens on the M side and the G rows on the N
// side), TMA, a pipelined ring of stages and a fitted BN are work for a
// later version.
//
// rbgp4mm_rhs_stacked, the second entry point, replaces the Pallas TPU
// kernel repro/kernels/rbgp4mm.py:rbgp4mm_rhs_stacked
// (_mm_rhs_stacked_kernel): Y[e] = act(X[e] . W_s[e]^T + b[e]) for every
// expert e of a MoE layer in one launch, X (E, N, K), w (E, M, d_o*d_i*C),
// bias (E, M), with Z as above and no residual.  All experts share one
// layout, so every expert reads the same col0 table.  It is the same
// device body (rhs_tile) with the expert on blockIdx.z: each block offsets
// its pointers by its expert's stride (x + e*N*K, w + e*M*nnz_row,
// bias + e*M, Y and Z + e*N*M); the unstacked entry point is its E = 1
// case.  Each entry point launches its own __global__ symbol
// (rbgp4mm_rhs_kernel, rbgp4mm_rhs_stacked_kernel), so that a profile
// tells them apart.  What bounds it on an H100: bytes, at every shape a
// qwen2-moe-a2.7b expert projection runs.  At decode (8 token rows an
// expert) reading the weights, 60*1408*512*2 B = 86.5 MB per launch of a
// gate or up projection (the down projection the same), 25.8 us at
// 3.35 TB/s; at a training step (171 rows an expert) X, W and Y come to
// 157 MB (47 us) against 15 us for the 14.8 GFLOP on the tensor cores.
// What the design does about it: nothing yet, it is the FMA design above;
// tensor cores, TMA and a ring come with the later version of all the
// kernels.
//
// The int8 path (rbgp4mm_rhs_q, rbgp4mm_rhs_stacked_q; the reference's
// has_scales branch of _mm_rhs_kernel and _mm_rhs_stacked_kernel, in
// _rhs_accumulate): weight-only PTQ storage, w int8 (same shape) and
// scales (M/G, d_o*d_i) float32, one scale per (G x C) leaf block, i.e. per
// (row group rg, slot s): scales[rg*(d_o*d_i) + s], and for expert e of
// the stacked entry point at offset e*(M/G)*(d_o*d_i).  It is the same
// device body: the W staging loop loads the int8 value and multiplies it
// by its slot's one scale in f32 (q * scale, as the plain version
// dequantizes) where the f32/bf16 path converts the value; sums stay f32,
// X and Y keep their type (f32 or bf16).  The epilogue is off (the caller
// applies bias, activation and residual in torch, as the reference's
// dispatcher does) and there is no Z: PTQ storage has no gradient.  What
// bounds it on an H100: bytes, at decode, as above, with a value at 1 byte
// instead of bf16's 2 plus 4/(G*C) bytes of scale, so a little over half
// the bf16 path's bound.  The design does nothing more for it yet: one
// byte a thread per load (char4 / 16-byte loads, cp.async and tensor
// cores are later work), so the time tracks the bf16 path's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kAccPerThread = 4;  // BN * G <= kThreads * kAccPerThread
constexpr int kTileC = 64;        // columns staged per pass
constexpr int kMaxBlockTokens = 64;

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3 };

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

__device__ __forceinline__ float activate(float z, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(z, 0.0f);
    case kGelu: {  // tanh approximation, as jax.nn.gelu(approximate=True)
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * z * (1.0f + tanhf(c * (z + 0.044715f * z * z * z)));
    }
    case kSilu:
      return z / (1.0f + expf(-z));
    default:
      return z;
  }
}

// The body of all four entry kernels below: one (BN tokens x G rows) tile
// of row group blockIdx.x, token block blockIdx.y, expert blockIdx.z.  W is
// the value type: T, or int8_t with one float scale per leaf block.
template <typename T, typename W>
__device__ __forceinline__ void rhs_tile(
    const T* __restrict__ x, const W* __restrict__ w,
    const float* __restrict__ scales, const int* __restrict__ col0,
    const T* __restrict__ bias, const T* __restrict__ residual,
    T* __restrict__ out, T* __restrict__ zout, int n_tokens, int k, int m,
    int n_chunks, int G, int C, int bn, int act) {
  constexpr bool kInt8 = std::is_same<W, int8_t>::value;
  // expert e = blockIdx.z (0 for the unstacked entry point): its operands
  // start at e times their per-expert sizes
  const long long e = blockIdx.z;
  const long long w_row = (long long)n_chunks * C;  // compact row length
  x += e * n_tokens * k;
  w += e * m * w_row;
  if constexpr (kInt8) scales += e * (m / G) * n_chunks;
  if (bias != nullptr) bias += e * m;
  out += e * n_tokens * m;
  if (zout != nullptr) zout += e * n_tokens * m;
  if (residual != nullptr) residual += e * n_tokens * m;

  extern __shared__ float smem[];
  const int ct = C < kTileC ? C : kTileC;  // staged columns per pass
  const int ld = ct + 1;                   // padded row stride: no conflicts
  float* xs = smem;                        // (bn, ld)
  float* ws = smem + bn * ld;              // (G, ld)

  const int rg = blockIdx.x;  // row group: output rows rg*G .. rg*G + G-1
  const int n0 = blockIdx.y * bn;
  const int tid = threadIdx.x;
  const int n_out = bn * G;

  float acc[kAccPerThread];
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) acc[a] = 0.0f;

  const int* cols = col0 + (long long)rg * n_chunks;
  const W* w_blk = w + (long long)rg * G * w_row;
  for (int s = 0; s < n_chunks; ++s) {
    const int c_base = cols[s];  // input column of slot (s, c = 0)
    // the (G x C) leaf block of slot s has one scale (int8 path only)
    float scale = 1.0f;
    if constexpr (kInt8) scale = scales[(long long)rg * n_chunks + s];
    for (int c0 = 0; c0 < C; c0 += ct) {
      const int cw = min(ct, C - c0);  // live columns in this pass
      // x[n0 : n0+bn, c_base+c0 : +cw], zeros past the token edge
      for (int i = tid; i < bn * ct; i += kThreads) {
        const int r = i / ct;
        const int c = i - r * ct;
        const int n = n0 + r;
        float v = 0.0f;
        if (n < n_tokens && c < cw)
          v = to_f32(x[(long long)n * k + c_base + c0 + c]);
        xs[r * ld + c] = v;
      }
      // w[rg*G : rg*G+G, s*C+c0 : +cw]
      for (int i = tid; i < G * ct; i += kThreads) {
        const int g = i / ct;
        const int c = i - g * ct;
        float v = 0.0f;
        if (c < cw) {
          const W q = w_blk[(long long)g * w_row + (long long)s * C + c0 + c];
          if constexpr (kInt8)
            v = static_cast<float>(q) * scale;
          else
            v = to_f32(q);
        }
        ws[g * ld + c] = v;
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < kAccPerThread; ++a) {
        const int o = tid + a * kThreads;
        if (o < n_out) {
          const float* xr = xs + (o / G) * ld;
          const float* wr = ws + (o % G) * ld;
          float sum = acc[a];
          for (int c = 0; c < ct; ++c) sum = fmaf(xr[c], wr[c], sum);
          acc[a] = sum;
        }
      }
      __syncthreads();
    }
  }

  // epilogue on the f32 accumulators, then one store
#pragma unroll
  for (int a = 0; a < kAccPerThread; ++a) {
    const int o = tid + a * kThreads;
    const int n = n0 + o / G;
    if (o < n_out && n < n_tokens) {
      const int row = rg * G + o % G;
      float z = acc[a];
      if (bias != nullptr) z += to_f32(bias[row]);
      const long long idx = (long long)n * m + row;
      if (zout != nullptr) zout[idx] = from_f32<T>(z);
      float y = activate(z, act);
      if (residual != nullptr) y += to_f32(residual[idx]);
      out[idx] = from_f32<T>(y);
    }
  }
}

// Four entry kernels with one body, so that a profile of the card tells
// the stacked launches and the int8 ones from the others.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rbgp4mm_rhs_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const int* __restrict__ col0,
                       const T* __restrict__ bias,
                       const T* __restrict__ residual, T* __restrict__ out,
                       T* __restrict__ zout, int n_tokens, int k, int m,
                       int n_chunks, int G, int C, int bn, int act) {
  rhs_tile<T, T>(x, w, nullptr, col0, bias, residual, out, zout, n_tokens,
                 k, m, n_chunks, G, C, bn, act);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rbgp4mm_rhs_stacked_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const int* __restrict__ col0, const T* __restrict__ bias,
    const T* __restrict__ residual, T* __restrict__ out,
    T* __restrict__ zout, int n_tokens, int k, int m, int n_chunks, int G,
    int C, int bn, int act) {
  rhs_tile<T, T>(x, w, nullptr, col0, bias, residual, out, zout, n_tokens,
                 k, m, n_chunks, G, C, bn, act);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rbgp4mm_rhs_q_kernel(const T* __restrict__ x,
                         const int8_t* __restrict__ q,
                         const float* __restrict__ scales,
                         const int* __restrict__ col0, T* __restrict__ out,
                         int n_tokens, int k, int m, int n_chunks, int G,
                         int C, int bn) {
  rhs_tile<T, int8_t>(x, q, scales, col0, nullptr, nullptr, out, nullptr,
                      n_tokens, k, m, n_chunks, G, C, bn, kNone);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rbgp4mm_rhs_stacked_q_kernel(const T* __restrict__ x,
                                 const int8_t* __restrict__ q,
                                 const float* __restrict__ scales,
                                 const int* __restrict__ col0,
                                 T* __restrict__ out, int n_tokens, int k,
                                 int m, int n_chunks, int G, int C, int bn) {
  rhs_tile<T, int8_t>(x, q, scales, col0, nullptr, nullptr, out, nullptr,
                      n_tokens, k, m, n_chunks, G, C, bn, kNone);
}

// Token rows per block: a power of two covering n_tokens (so a decode
// step stages no empty rows), at most kMaxBlockTokens, and few enough that
// the block's BN x G outputs fit its threads' accumulators.  0 when G alone
// is too large.
int block_tokens(int n_tokens, int G) {
  int bn = 1;
  while (bn < n_tokens && bn < kMaxBlockTokens) bn *= 2;
  const int cap = kThreads * kAccPerThread / G;
  return bn < cap ? bn : cap;
}

// The launch shape shared by every entry point: token rows per block, grid
// and shared memory; false when the shapes are refused.
struct Plan {
  int bn;
  dim3 grid;
  size_t smem;
};

bool plan_launch(int n_experts, int n_tokens, int m, int G, int C,
                 Plan* p) {
  if (G < 1 || C < 1 || m % G != 0 || n_tokens < 1 || n_experts < 1 ||
      n_experts > 65535)
    return false;
  p->bn = block_tokens(n_tokens, G);
  if (p->bn < 1) return false;
  const int ct = C < kTileC ? C : kTileC;
  p->smem = (size_t)(p->bn + G) * (ct + 1) * sizeof(float);
  if (p->smem > 48 * 1024) return false;
  p->grid = dim3(m / G, (n_tokens + p->bn - 1) / p->bn, n_experts);
  return true;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* col0,
                   const void* bias, const void* residual, void* out,
                   void* zout, bool stacked, int n_experts, int n_tokens,
                   int k, int m, int n_chunks, int G, int C, int act,
                   cudaStream_t stream) {
  Plan p;
  if (!plan_launch(n_experts, n_tokens, m, G, C, &p))
    return cudaErrorInvalidValue;
  const int bn = p.bn;
  const dim3 grid = p.grid;
  const size_t smem = p.smem;
  const auto kernel =
      stacked ? rbgp4mm_rhs_stacked_kernel<T> : rbgp4mm_rhs_kernel<T>;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(col0), static_cast<const T*>(bias),
      static_cast<const T*>(residual), static_cast<T*>(out),
      static_cast<T*>(zout), n_tokens, k, m, n_chunks, G, C, bn, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_q(const void* x, const void* q, const void* scales,
                     const void* col0, void* out, bool stacked,
                     int n_experts, int n_tokens, int k, int m, int n_chunks,
                     int G, int C, cudaStream_t stream) {
  Plan p;
  if (!plan_launch(n_experts, n_tokens, m, G, C, &p))
    return cudaErrorInvalidValue;
  const auto kernel =
      stacked ? rbgp4mm_rhs_stacked_q_kernel<T> : rbgp4mm_rhs_q_kernel<T>;
  kernel<<<p.grid, kThreads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scales), static_cast<const int*>(col0),
      static_cast<T*>(out), n_tokens, k, m, n_chunks, G, C, p.bn);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  act: 0 none, 1 relu, 2 gelu, 3 silu.
// bias, residual and zout (the pre-activation output) may be null.
// Returns the cudaError_t of the launch.
extern "C" int rbgp4mm_rhs_launch(int dtype, const void* x, const void* w,
                                  const void* col0, const void* bias,
                                  const void* residual, void* out,
                                  void* zout, int n_tokens, int k, int m,
                                  int n_chunks, int G, int C, int act,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, w, col0, bias, residual, out, zout, false,
                              1, n_tokens, k, m, n_chunks, G, C, act, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, col0, bias, residual, out,
                                      zout, false, 1, n_tokens, k, m,
                                      n_chunks, G, C, act, s);
  return (int)cudaErrorInvalidValue;
}

// The stacked entry point: x (E, N, K), w (E, M, n_chunks*C), bias (E, M)
// or null, out and zout (E, N, M), zout may be null; one launch for all E
// experts over the one col0 table.  Returns the cudaError_t of the launch.
extern "C" int rbgp4mm_rhs_stacked_launch(int dtype, const void* x,
                                          const void* w, const void* col0,
                                          const void* bias, void* out,
                                          void* zout, int n_experts,
                                          int n_tokens, int k, int m,
                                          int n_chunks, int G, int C,
                                          int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, w, col0, bias, nullptr, out, zout, true,
                              n_experts, n_tokens, k, m, n_chunks, G, C, act,
                              s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, col0, bias, nullptr, out, zout,
                                      true, n_experts, n_tokens, k, m,
                                      n_chunks, G, C, act, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 entry points: x (N, K) or (E, N, K) of dtype, q int8 of the
// compact shape (M, n_chunks*C) or (E, M, n_chunks*C), scales float32
// (M/G, n_chunks) or (E, M/G, n_chunks), out like x's rows by M.  No
// epilogue.  Each returns the cudaError_t of the launch.
extern "C" int rbgp4mm_rhs_q_launch(int dtype, const void* x, const void* q,
                                    const void* scales, const void* col0,
                                    void* out, int n_tokens, int k, int m,
                                    int n_chunks, int G, int C,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_q<float>(x, q, scales, col0, out, false, 1, n_tokens,
                                k, m, n_chunks, G, C, s);
  if (dtype == 1)
    return (int)launch_q<__nv_bfloat16>(x, q, scales, col0, out, false, 1,
                                        n_tokens, k, m, n_chunks, G, C, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rbgp4mm_rhs_stacked_q_launch(int dtype, const void* x,
                                            const void* q,
                                            const void* scales,
                                            const void* col0, void* out,
                                            int n_experts, int n_tokens,
                                            int k, int m, int n_chunks,
                                            int G, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_q<float>(x, q, scales, col0, out, true, n_experts,
                                n_tokens, k, m, n_chunks, G, C, s);
  if (dtype == 1)
    return (int)launch_q<__nv_bfloat16>(x, q, scales, col0, out, true,
                                        n_experts, n_tokens, k, m, n_chunks,
                                        G, C, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rbgp4mm_rhs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
