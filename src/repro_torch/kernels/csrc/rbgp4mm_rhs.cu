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
// Two device bodies.  Which one a launch takes is a fixed function of
// dtype and shape, chosen by the caller (kernels/rbgp4mm.py:rhs_path) and
// passed as `path`; the launcher refuses a shape the chosen body cannot
// take, and nothing falls back from one body to the other.
//
// 1. The bf16 tensor-core body, rbgp4mm_rhs_mma_kernel<G> and, for the
// stacked entry point, rbgp4mm_rhs_stacked_mma_kernel<G, BN> (path 1):
// full precision in bfloat16 at N >= 16 tokens (rows an expert, stacked),
// G in {16, 32, 64, 128}, C and K multiples of 8.  That is every launch
// of a training step (the forward, its remat recompute and dX, N = 4096
// for tinyllama-1.1b at 8 x 512 tokens, 171 rows an expert for
// qwen2-moe-a2.7b at 4 x 512) and of a prefill.
//
// What bounds it on an H100.  Per tinyllama-1.1b layer at N = 4096, the
// seven projections hold 11.01 M compact values, so each of the forward
// and dX does 2 * 4096 * 11.01e6 = 90.2 GFLOP: 0.091 ms at the 989
// TFLOP/s bf16 dense peak, against about 0.1 ms of device-memory bytes
// (X, W, Y and Z once).  The limit this design meets first is neither:
// it is L2.  A block stages, for each (row group, slot) pair, the N x C
// input slice at col0[rg, s], and that slice feeds only the G rows of the
// group.  On the forward layouts (G = 16; C = 128, or 64 with 22 chunks a
// row for down) that is sum (M/G) * n_chunks * N * C * 2 bytes =
// 2 * 537 MB (wq, wo) + 2 * 67 MB (wk, wv) + 2 * 1476 MB (gate, up) +
// 1476 MB (down) = 5.64 GB of L2-to-SM reads a layer, plus 0.70 GB of
// weights (re-read once for every 128 tokens), about 1 ms at the 5-6
// TB/s an H100's L2 gives.  On the dX layouts (G = 128, or 64 for down;
// C = 16) the input slices come to 0.89 GB and the weights to 0.70 GB:
// 1.6 GB, about 0.3 ms.  Measured (NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py phase 3): the forward 1.63 ms a layer, so about 3.9 TB/s
// of those reads (rbgp4_sddmm_rhs reads the same slices at about 6
// TB/s); dX 0.63 ms.  Blocks that walk several token tiles each (fewer,
// longer-lived blocks) were tried and ran slower: the grid's waves, not
// the blocks' start-up, set the pace.
//
// What the design does about it.  A block owns kMmaBN = 128 tokens by the
// G rows of one row group, so one weight slice now serves 128 tokens
// (the FMA body's dX blocks held 8 at G = 128 and re-read W N/8 times).
// Tokens are the mma's M side, the G rows its N side and the row group's
// compact columns kk = s*C + c its contraction: mma.sync m16n8k16
// (bf16 in, f32 sums), fragments by ldmatrix.  A (G x C) slot of W in
// row-major compact storage is already the .col B operand, and X's rows
// the .row A operand, so nothing is transposed.  The contraction runs in
// stages of kMmaKS = 64 compact columns; a stage's X (128 x 64, gathered
// 8 columns at a time through col0: C % 8 == 0, so a 16-byte chunk never
// straddles a slot) and W (G x 64) slices arrive by 16-byte cp.async in a
// ring of kMmaStages = 3, two stages in flight while the third is
// multiplied, with one __syncthreads a stage.  Rows are 128 bytes, XOR-
// swizzled by 16-byte chunk (mma_bf16.cuh), so ldmatrix meets no bank
// conflict.  Columns past n_chunks*C and tokens past N are zero-filled by
// the copy itself (src-size 0), so the ragged edges need no other code.
// The 8 warps split the tile 8 x 1 (G = 16, 32) or 4 x 2 (G = 64, 128);
// a warp holds 16-32 tokens by 16-64 rows of f32 sums.  The epilogue
// (bias, Z, activation, residual) runs on those fragments as the FMA
// body's does, then one bf16x2 store of Y (and Z) a pair of rows.  L2
// traffic of the forward's input slices is what is left; cutting it needs
// a block that serves several row groups from one staged slice (the row
// groups u of one tile-row o read the same adj_o tiles), later work.
//
// Build (nvcc -Xptxas -v, sm_90a): G = 16, 32, 64, 128 use 64, 62, 64 and
// 124 registers and no stack (no spills); dynamic shared memory
// 3 * (BN + G) * 64 * 2 bytes = 55,296, 61,440, 73,728 and 98,304
// bytes at BN = 128, above the 48 KB default, so each launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize.  Refused (launcher):
// float32, G outside those four, C or K not a multiple of 8, X or W not
// 16-byte aligned (the wrapper checks first and raises), more than
// 65535 token tiles, a 64-token tile or a residual on the unstacked or
// stacked entry point respectively.
//
// 2. The FMA body, rhs_tile (path 0): float32 (TF32 stays off, so the
// float32 parity runs keep this body), bf16 below 16 tokens (decode at 8
// rows, where the step is host-bound; the tensor-core body was measured
// faster from 8 tokens on, kernels/rbgp4mm.py:MMA_MIN_TOKENS), the int8
// entry points, and any G or C, stacked or not.  What bounds it on an
// H100: at decode (8 token rows) every weight is read once per step and
// used for 8 products: about 154 launches and 0.48 GB of bf16 weights per
// step of tinyllama-1.1b, so reading W from device memory bounds it
// (3.35 TB/s).  One block computes a (BN tokens x G rows) tile of one row
// group, walks the d_o*d_i chunks, stages each (BN x C) input slice and
// (G x C) weight slice in shared memory (converted to f32, in passes of
// at most 64 columns) and multiplies them with FMAs on the CUDA cores,
// each thread holding up to four outputs in registers, two shared-memory
// loads per FMA.  The epilogue (bias, Z, activation, residual) runs on
// those registers before the single store of Y (and of Z).  No sum
// crosses blocks.  BN (block_tokens) is a power of two covering the
// tokens, at most 64, and at most 1024 / G: 8 tokens at G = 128.  The
// ragged token edge is masked here.  Any C and any G up to 128 work; a G
// whose staging needs more than the 48 KB of shared memory a launch gets
// by default is refused.
//
// rbgp4mm_rhs_stacked, the second entry point, replaces the Pallas TPU
// kernel repro/kernels/rbgp4mm.py:rbgp4mm_rhs_stacked
// (_mm_rhs_stacked_kernel): Y[e] = act(X[e] . W_s[e]^T + b[e]) for every
// expert e of a MoE layer in one launch, X (E, N, K), w (E, M, d_o*d_i*C),
// bias (E, M), with Z as above and no residual.  All experts share one
// layout, so every expert reads the same col0 table.  It runs the same
// two device bodies, with the expert on blockIdx.z: each block offsets
// its pointers by its expert's stride (x + e*N*K, w + e*M*nnz_row,
// bias + e*M, Y and Z + e*N*M), so an expert's outputs are the bits the
// unstacked launch of the same body gives on that expert's slice.  Each
// entry point launches its own __global__ symbol (rbgp4mm_rhs_kernel and
// rbgp4mm_rhs_mma_kernel, rbgp4mm_rhs_stacked_kernel and
// rbgp4mm_rhs_stacked_mma_kernel), so that a profile tells them apart;
// the same rhs_path chooses the body, from the rows an expert.
//
// What bounds it on an H100.  At decode (8 token rows an expert, the FMA
// body) reading the weights, 60*1408*512*2 B = 86.5 MB per launch of a
// gate or up projection (the down projection the same), 25.8 us at 3.35
// TB/s.  At a training step (171 rows an expert) X, W and Y come to 157
// MB (47 us) against 15 us for the 14.8 GFLOP on the tensor cores; the
// tensor-core body meets L2 first, as the unstacked one does: a gate or
// up block (G = 16, C = 128) gathers BN x nnz_row of X for 16 rows.  At
// 171 rows the second 128-token tile is 43/128 full, so the stacked entry
// point also builds a 64-token tile (BN = 64: the same warp tiles, four
// warps, block_tokens).  The wrapper takes it (kernels/rbgp4mm.py:
// stacked_mma_block_tokens) for dX, and for the forward where the last
// 128-token tile would be at most half full (171 rows then compute 192
// instead of 256), else 128: the faster tile at every size
// chip_smoke.py's stacked tile sweep timed (NVIDIA H100 80GB HBM3, 700
// W; per MoE layer at 16-512 rows an expert).  At 171 rows the forward
// took 0.946 ms at BN = 64 against 1.059 at 128, dX 0.659 against 0.885;
// at 512 the forward 2.568 against 2.400, dX 1.714 against 2.018.  The
// tile changes no bit (the sweep holds the two bit-equal): each output's
// sums run the same mma sequence over the contraction.
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

#include "mma_bf16.cuh"

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

// The FMA body of all four entry kernels below: one (BN tokens x G rows) tile
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

// -- the bf16 tensor-core body ---------------------------------------------

constexpr int kMmaBN = 128;       // tokens a block (the mma's M side)
constexpr int kMmaKS = 64;        // contraction columns a stage
constexpr int kMmaStages = 3;     // cp.async ring depth

// The warp grid of a (BN tokens x G rows) block tile: WARPS_M x WARPS_N
// warps, each MT m16 tiles of tokens by NT n8 tiles of rows.  BN = 128
// (kMmaBN, every unstacked launch) runs 8 warps; BN = 64, which only the
// stacked entry point takes, runs the same warp tiles with half the warps.
template <int G, int BN>
struct RhsMma {
  static constexpr int kWarpsN = G >= 64 ? 2 : 1;
  static constexpr int kWarpsM = (BN / 16) / (G >= 64 ? 2 : 1);
  static constexpr int kThreads = kWarpsM * kWarpsN * 32;
  static constexpr int kWTM = BN / kWarpsM;      // tokens a warp
  static constexpr int kWTN = G / kWarpsN;       // rows a warp
  static constexpr int kMT = kWTM / 16;
  static constexpr int kNT = kWTN / 8;
  static constexpr size_t kSmem =
      (size_t)kMmaStages * (BN + G) * kMmaKS * sizeof(__nv_bfloat16);
  static_assert(BN == 64 || BN == 128, "block tokens");
  static_assert(kWTM % 16 == 0 && kWTN % 16 == 0, "warp tile");
};

// The tensor-core body of both mma entry kernels below: one (BN tokens x
// G rows) tile of row group blockIdx.x, token block blockIdx.y, on
// operands already offset to the block's expert.  The contraction runs
// over the row group's compact columns kk = s*C + c, kk < n_chunks*C, in
// stages of kMmaKS: compact column kk of W is w[row, kk] and meets input
// column col0[rg, s] + c of X.  Each stage's X (BN x kMmaKS) and W (G x
// kMmaKS) slices arrive by 16-byte cp.async (8 columns never straddle a
// slot: C % 8 == 0) in a ring of kMmaStages; columns past n_chunks*C and
// tokens past n_tokens are zero-filled.
template <int G, int BN>
__device__ __forceinline__ void rhs_mma_tile(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const int* __restrict__ col0, const __nv_bfloat16* __restrict__ bias,
    const __nv_bfloat16* __restrict__ residual,
    __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ zout,
    int n_tokens, int k, int m, int n_chunks, int C, int act) {
  using S = RhsMma<G, BN>;
  using mma_bf16::swz;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ws = xs + kMmaStages * BN * kMmaKS;

  const int rg = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % S::kWarpsM;
  const int wn = warp / S::kWarpsM;
  const long long w_row = (long long)n_chunks * C;
  const int len = n_chunks * C;
  const int n_steps = (len + kMmaKS - 1) / kMmaKS;
  const int* cols = col0 + (long long)rg * n_chunks;
  const __nv_bfloat16* w_blk = w + (long long)rg * G * w_row;

  auto load_stage = [&](int step, int slot) {
    __nv_bfloat16* xd = xs + slot * BN * kMmaKS;
    __nv_bfloat16* wd = ws + slot * G * kMmaKS;
#pragma unroll
    for (int i = tid; i < BN * 8; i += S::kThreads) {
      const int r = i >> 3, j = i & 7;
      const int kk = step * kMmaKS + j * 8;
      const int n = n0 + r;
      const bool ok = n < n_tokens && kk < len;
      const __nv_bfloat16* src = x;
      if (ok) {
        const int s = kk / C;
        src = x + (long long)n * k + cols[s] + (kk - s * C);
      }
      mma_bf16::cp_async16(xd + swz<8>(r, j), src, ok);
    }
#pragma unroll
    for (int i = tid; i < G * 8; i += S::kThreads) {
      const int r = i >> 3, j = i & 7;
      const int kk = step * kMmaKS + j * 8;
      const bool ok = kk < len;
      const __nv_bfloat16* src = ok ? w_blk + (long long)r * w_row + kk : w;
      mma_bf16::cp_async16(wd + swz<8>(r, j), src, ok);
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
    const __nv_bfloat16* xt = xs + slot * BN * kMmaKS;
    const __nv_bfloat16* wt = ws + slot * G * kMmaKS;
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
        // rows t*16 .. +15 of the warp's W rows: matrices (rows 0-7,
        // k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 0-7), (rows 8-15,
        // k 8-15) = b0, b1 of n8 tile 2t and b0, b1 of tile 2t+1
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

  // epilogue on the f32 fragments: c0, c1 at (token lane/4, rows
  // 2*(lane%4) + {0, 1}), c2, c3 eight tokens further; then one bf16x2
  // store of Y (and of Z) per pair
#pragma unroll
  for (int i = 0; i < S::kMT; ++i)
#pragma unroll
    for (int t = 0; t < S::kNT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + wm * S::kWTM + i * 16 + (lane >> 2) + h * 8;
        if (n >= n_tokens) continue;
        const int row = rg * G + wn * S::kWTN + t * 8 + (lane & 3) * 2;
        float z0 = acc[i][t][2 * h], z1 = acc[i][t][2 * h + 1];
        if (bias != nullptr) {
          z0 += __bfloat162float(bias[row]);
          z1 += __bfloat162float(bias[row + 1]);
        }
        const long long idx = (long long)n * m + row;
        if (zout != nullptr)
          *reinterpret_cast<__nv_bfloat162*>(zout + idx) =
              __floats2bfloat162_rn(z0, z1);
        float y0 = activate(z0, act), y1 = activate(z1, act);
        if (residual != nullptr) {
          y0 += __bfloat162float(residual[idx]);
          y1 += __bfloat162float(residual[idx + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + idx) =
            __floats2bfloat162_rn(y0, y1);
      }
}

// Two entry kernels with one tensor-core body, so that a profile of the
// card tells the stacked launches from the others.
template <int G>
__global__ void __launch_bounds__(RhsMma<G, kMmaBN>::kThreads)
    rbgp4mm_rhs_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           const int* __restrict__ col0,
                           const __nv_bfloat16* __restrict__ bias,
                           const __nv_bfloat16* __restrict__ residual,
                           __nv_bfloat16* __restrict__ out,
                           __nv_bfloat16* __restrict__ zout, int n_tokens,
                           int k, int m, int n_chunks, int C, int act) {
  rhs_mma_tile<G, kMmaBN>(x, w, col0, bias, residual, out, zout, n_tokens,
                          k, m, n_chunks, C, act);
}

// Expert e = blockIdx.z: x, w, bias, Y and Z offset by its strides (x +
// e*N*K, w + e*M*nnz_row, bias + e*M, Y and Z + e*N*M), no residual.
template <int G, int BN>
__global__ void __launch_bounds__(RhsMma<G, BN>::kThreads)
    rbgp4mm_rhs_stacked_mma_kernel(const __nv_bfloat16* __restrict__ x,
                                   const __nv_bfloat16* __restrict__ w,
                                   const int* __restrict__ col0,
                                   const __nv_bfloat16* __restrict__ bias,
                                   __nv_bfloat16* __restrict__ out,
                                   __nv_bfloat16* __restrict__ zout,
                                   int n_tokens, int k, int m, int n_chunks,
                                   int C, int act) {
  const long long e = blockIdx.z;
  const long long w_row = (long long)n_chunks * C;
  x += e * n_tokens * k;
  w += e * m * w_row;
  if (bias != nullptr) bias += e * m;
  out += e * n_tokens * m;
  if (zout != nullptr) zout += e * n_tokens * m;
  rhs_mma_tile<G, BN>(x, w, col0, bias, nullptr, out, zout, n_tokens, k, m,
                      n_chunks, C, act);
}

template <int G, int BN>
cudaError_t launch_mma_g(const void* x, const void* w, const void* col0,
                         const void* bias, const void* residual, void* out,
                         void* zout, int n_experts, int n_tokens, int k,
                         int m, int n_chunks, int C, int act, bool stacked,
                         cudaStream_t stream) {
  using S = RhsMma<G, BN>;
  const dim3 grid(m / G, (n_tokens + BN - 1) / BN, n_experts);
  const auto xp = static_cast<const __nv_bfloat16*>(x);
  const auto wp = static_cast<const __nv_bfloat16*>(w);
  const auto cp = static_cast<const int*>(col0);
  const auto bp = static_cast<const __nv_bfloat16*>(bias);
  const auto op = static_cast<__nv_bfloat16*>(out);
  const auto zp = static_cast<__nv_bfloat16*>(zout);
  cudaError_t err;
  if (stacked) {
    const auto kernel = rbgp4mm_rhs_stacked_mma_kernel<G, BN>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, S::kThreads, S::kSmem, stream>>>(
        xp, wp, cp, bp, op, zp, n_tokens, k, m, n_chunks, C, act);
  } else {
    if constexpr (BN == kMmaBN) {
      const auto kernel = rbgp4mm_rhs_mma_kernel<G>;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, S::kThreads, S::kSmem, stream>>>(
          xp, wp, cp, bp, static_cast<const __nv_bfloat16*>(residual), op,
          zp, n_tokens, k, m, n_chunks, C, act);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_mma_bn(const void* x, const void* w, const void* col0,
                          const void* bias, const void* residual, void* out,
                          void* zout, int n_experts, int n_tokens, int k,
                          int m, int n_chunks, int C, int act, bool stacked,
                          int block_tokens, cudaStream_t stream) {
  if (block_tokens == 128)
    return launch_mma_g<G, 128>(x, w, col0, bias, residual, out, zout,
                                n_experts, n_tokens, k, m, n_chunks, C, act,
                                stacked, stream);
  if (block_tokens == 64 && stacked)
    return launch_mma_g<G, 64>(x, w, col0, bias, residual, out, zout,
                               n_experts, n_tokens, k, m, n_chunks, C, act,
                               stacked, stream);
  return cudaErrorInvalidValue;
}

// The mma body: bf16 only, G in {16, 32, 64, 128}, C and K multiples of
// 8 (16-byte chunks never straddle a slot or a row), x and w 16-byte
// aligned, block_tokens 128 (or 64, stacked only); anything else is
// refused (the caller's path choice is wrong).  The stacked entry point
// has no residual.
cudaError_t launch_mma(const void* x, const void* w, const void* col0,
                       const void* bias, const void* residual, void* out,
                       void* zout, int n_experts, int n_tokens, int k, int m,
                       int n_chunks, int G, int C, int act, bool stacked,
                       int block_tokens, cudaStream_t stream) {
  if (n_tokens < 1 || n_chunks < 1 || C < 8 || C % 8 != 0 || k % 8 != 0 ||
      n_experts < 1 || n_experts > 65535 || (stacked && residual != nullptr) ||
      block_tokens < 1 ||
      m % G != 0 || (n_tokens + block_tokens - 1) / block_tokens > 65535 ||
      !mma_bf16::aligned16(x) || !mma_bf16::aligned16(w) ||
      (long long)n_chunks * C > 2147483647LL - kMmaKS)
    return cudaErrorInvalidValue;
  switch (G) {
    case 16:
      return launch_mma_bn<16>(x, w, col0, bias, residual, out, zout,
                               n_experts, n_tokens, k, m, n_chunks, C, act,
                               stacked, block_tokens, stream);
    case 32:
      return launch_mma_bn<32>(x, w, col0, bias, residual, out, zout,
                               n_experts, n_tokens, k, m, n_chunks, C, act,
                               stacked, block_tokens, stream);
    case 64:
      return launch_mma_bn<64>(x, w, col0, bias, residual, out, zout,
                               n_experts, n_tokens, k, m, n_chunks, C, act,
                               stacked, block_tokens, stream);
    case 128:
      return launch_mma_bn<128>(x, w, col0, bias, residual, out, zout,
                                n_experts, n_tokens, k, m, n_chunks, C, act,
                                stacked, block_tokens, stream);
    default:
      return cudaErrorInvalidValue;
  }
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
// path: 0 the FMA body, 1 the bf16 tensor-core body (the caller's choice,
// kernels/rbgp4mm.py:rhs_path; a shape or dtype the mma body cannot take
// is refused).  Returns the cudaError_t of the launch.
extern "C" int rbgp4mm_rhs_launch(int dtype, const void* x, const void* w,
                                  const void* col0, const void* bias,
                                  const void* residual, void* out,
                                  void* zout, int n_tokens, int k, int m,
                                  int n_chunks, int G, int C, int act,
                                  int path, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(x, w, col0, bias, residual, out, zout, 1,
                           n_tokens, k, m, n_chunks, G, C, act, false,
                           kMmaBN, s);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
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
// experts over the one col0 table.  path as rbgp4mm_rhs_launch's; the
// tensor-core body takes block_tokens tokens a block (128 or 64; the
// caller's kernels/rbgp4mm.py:RHS_MMA_BLOCK_TOKENS), the FMA body ignores
// it.  Returns the cudaError_t of the launch.
extern "C" int rbgp4mm_rhs_stacked_launch(int dtype, const void* x,
                                          const void* w, const void* col0,
                                          const void* bias, void* out,
                                          void* zout, int n_experts,
                                          int n_tokens, int k, int m,
                                          int n_chunks, int G, int C,
                                          int act, int path,
                                          int block_tokens, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(x, w, col0, bias, nullptr, out, zout, n_experts,
                           n_tokens, k, m, n_chunks, G, C, act, true,
                           block_tokens, s);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
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
