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
// Two device bodies.  Which one a launch takes is a fixed function of
// dtype and shape, chosen by the caller (kernels/rbgp4mm.py:fm_path) and
// passed as `path`, with the tensor-core body's tile (class rows, warps
// along the tokens and along the contraction: kernels/rbgp4mm.py:
// fm_mma_tile); the launcher refuses a shape or tile the chosen
// body cannot take, and nothing falls back from one body to the other.
//
// 1. The bf16 tensor-core body, rbgp4mm_mma_kernel<R, WM, WK> (path
// 1): bfloat16 at N >= 16, N a multiple of 8 (every row of I and O then
// starts 16-byte aligned), G in {8, 16, 32, 64}, C a multiple of 8.  That
// is every launch of a VGG19-CIFAR pass at batch 256: O on the forward
// tables (G = 16, 18 slots of C = 8-64) and dI on the transposed ones
// (C = 16, G = 8-64, 1-8 slots).
//
// What bounds it on an H100.  The bytes above, 0.327 ms a VGG19 pass for
// each of O and dI; this design meets L2 first.  A block gathers the
// input rows its rows' slots name, and with one row group a block they
// serve only its G rows: (M/G) * nnz_row * N * 2 bytes of L2 reads a
// layer, M*K*N/32 on the forward tables (302 MB at 64 x 576, N = 262144,
// and at 512 x 4608, N = 4096; 3.2 GB a pass, about 0.6 ms at the 5-6
// TB/s an H100's L2 gives) and twice the bytes of dI itself on the
// transposed ones.  But row groups with equal col0 rows read the same
// input rows, and the transposed tables hold whole classes of them: the
// outer graph of every VGG19 layout is complete, so all 9 tile-rows of
// the transposed layout read their one tile column, and row groups u of
// every tile-row share adj_i[u]: classes of 9 row groups (18 at 64 x 576).
// The forward tables have classes of 1 (C = 8, 16 at M <= 128) to 5.
//
// What the design does about it.  A block owns R rows of one row-group
// class (KernelTables.classes: the row groups whose col0 rows are equal,
// as the chain bodies walk them) by kMmaBN = 128 tokens, so one staged input
// slice serves every row of the tile.  Tokens are the mma's M side, the
// R class rows its N side (n8 tiles: G = 8 needs no padding) and the
// compact columns kk = s*C + c the contraction: mma.sync m16n8k16 (bf16
// in, f32 sums).  At the start the block writes two tables into shared
// memory: the input row each compact column reads, col0[c, kk/C] + kk%C,
// and the output row of each class row.  The contraction then runs in
// stages of kMmaKS = 64 compact columns, each stage's I slice (up to 64
// gathered rows x BN tokens: C = 8 puts two slots in one k16 step, rows
// of adjacent compact columns, so no slot is padded) and W slice (R rows
// x 64 compact columns) arriving by 16-byte cp.async in a ring of
// kMmaStages (rows XOR-swizzled by 16-byte chunk, mma_bf16.cuh), sized by
// the row (dI at 64 x 576, one k16 step, stages 16 rows in one slot).
// ldmatrix.trans turns the feature-major I slice into the row-major A =
// I^T fragment and plain ldmatrix the row-major W slice into the col-major
// B = W^T fragment.  The block's WM x WK warps split the tokens WM ways
// and the contraction WK ways: warp (wm, wk) takes k16 steps wk, wk + WK,
// ... of every stage, so no warp walks a long row alone where the grid
// is small (the FMA body's thread walked 18 slots x C columns in series,
// which left 512 x 4608 at N = 1024 latency-bound).  At the end the
// warps' f32 sums are added in shared memory in warp order (wk = 0, 1,
// ...), and each thread writes 8 consecutive tokens of a row of O with
// one 16-byte store, into the class row's own place.  No atomics and no
// sum crosses blocks: each output's sum runs over its row in one fixed
// order, so a rerun gives the same bits.  Columns past nnz_row (up to a
// whole k16 step), tokens past N and class rows past the class are
// zero-filled by the copy itself (src-size 0), and a block past its
// class's rows returns at once.
//
// chip_smoke.py's feature-major sweep timed every built tile of
// kernels/rbgp4mm.py:FM_MMA_TILES on both tables at VGG19-CIFAR's eight
// layer shapes (NVIDIA H100 80GB HBM3, 700 W): 32-row tiles (R = 64 at G
// >= 32) on 4 warps were the fastest for every dI, 0.82 ms a pass
// against 0.95 with one row group a block; O took 16-row tiles where the
// classes are single row groups, 32-row tiles elsewhere, 8 warps along
// the tokens, and 2 x 4 warps at 512 x 4608, N = 1024 (0.030 ms against
// 0.039 on 8 x 1): 0.84 ms a pass against 0.91.  A block that walked
// several token tiles through one ring, its epilogue tile apart, ran
// slower (the extra shared memory cost an SM a resident block).
//
// The sweep's other candidates (64 rows on 8 x 1 warps, 128 rows) were
// nowhere the fastest and are not built.  fm_mma_tile names each of the
// seven built tiles and no other: 64 rows only on 4 x 1 warps (rows of
// up to 128 compact columns; longer rows of G >= 32 take 32-row tiles,
// as 512 x 2304's dI at sparsity 0.5 does), 16 rows on 2 x 4 warps for
// the single-group forward classes below FM_MMA_SMALL_GRID blocks (64 x
// 576 to 128 x 1152 at N <= 4096), and 16 rows on 4 x 1 for
// single-group classes of short rows, which no VGG19-CIFAR or
// WRN-40-4 layout has at the paper's Table 1 sparsities.
//
// Build (nvcc -Xptxas -v, sm_90a): 40 to 125 registers, no spills, but
// for the 32-row tile on 4 x 1 warps (72 registers, 20 bytes of spill
// stores); dynamic shared memory FmSmem: up to 3 stages of (64 * 128 + R
// * 64) * 2 bytes, or the R x 132 f32 epilogue tile if larger, plus
// the two row tables (each launch sets cudaFuncAttributeMaxDynamicShared-
// MemorySize).  Refused (launcher): float32, G outside {8, 16, 32, 64}, C
// or N not a multiple of 8, x, w or out not 16-byte aligned (the wrapper
// checks x and w first and raises), a tile that is not built, more than
// 65535 token tiles.
//
// 2. The FMA body, rbgp4mm_kernel (path 0): float32 (TF32 stays off, so
// the float32 parity runs keep it), bf16 below 16 tokens or at N not a
// multiple of 8, and any G and C.  One block owns the G rows of one row
// group over a tile of columns of N.  Its threads split the G rows into
// subsets of GT rows (GT the largest power of two up to 16 dividing G),
// at most eight subsets a block: a row group of more than eight subsets
// is cut into passes of up to eight, one block each (the grid's z), each
// reading the group's input rows again.  Each thread holds GT x kCols f32
// sums in registers for kCols columns strided by the block's column
// threads, so every load of I is coalesced along N and feeds GT FMAs.
// The block walks its row group's d_o*d_i slots; for each it stages the
// pass's rows x C weight slice in shared memory as f32, transposed so
// that a thread's GT weights of one input row are contiguous (float4
// loads, broadcast across the warp), and reads the input rows straight
// from device memory.  No sum crosses blocks.  The ragged column edge is
// masked here, not padded by the caller.  The column threads per block
// (32 to 256) are picked per launch from the card's SM count, so that
// small N still gives about two blocks an SM.  Any G and C work (GT down
// to 1 for odd G, C staged in passes of up to 64 columns); M/G is at most
// 65535 (the grid's y).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

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

// -- the bf16 tensor-core body ---------------------------------------------

constexpr int kMmaBN = 128;      // tokens a block (the mma's M side)
constexpr int kMmaKS = 64;       // compact columns a stage (4 k16 steps)
constexpr int kMmaStages = 3;    // cp.async ring depth
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use

// The tile of a block: kMmaBN tokens by R class rows, on WM x WK warps;
// warp (wm, wk) = (warp % WM, warp / WM) owns tokens wm*kTM .. +kTM-1 (kMT
// m16 tiles) by all R rows (kNT n8 tiles) and k16 steps wk, wk + WK, ...
// of each stage.
template <int R, int WM, int WK>
struct FmMma {
  static constexpr int kThreads = WM * WK * 32;
  static constexpr int kTM = kMmaBN / WM;
  static constexpr int kMT = kTM / 16;
  static constexpr int kNT = R / 8;
  static constexpr int kXW = kMmaBN / 8;  // 16-byte chunks of a staged I row
  static constexpr int kLD = kMmaBN + 4;  // f32 pitch of the epilogue's rows
  static_assert(R == 16 || R == 32 || R == 64, "class rows");
  static_assert(kTM % 16 == 0, "warp tokens");
  static_assert(WK == 1 || WK == 2 || WK == 4, "contraction warps");
};

// The dynamic shared memory of a launch, sized by the row it walks (klen
// compact columns, a whole number of k16 steps), so that a short row (dI
// at 64 x 576: one k16 step) stages 16 rows in one slot: a ring of
// `slots` (kMmaStages, or the stages where there are fewer) of stage_rows
// gathered I rows x kMmaBN tokens, then as many W slices of R rows x
// kMmaKS columns; the epilogue's R x kLD f32 tile over the ring (it is
// written once the ring has drained); the input-row and output-row tables
// past both.  Host and device build it alike.
struct FmSmem {
  int stage_rows, slots;
  size_t w_off, table_off, total;
  __host__ __device__ FmSmem(int klen, int R) {
    constexpr int BN = kMmaBN;
    stage_rows = klen < kMmaKS ? klen : kMmaKS;
    const int n_steps = (klen + kMmaKS - 1) / kMmaKS;
    slots = n_steps < kMmaStages ? n_steps : kMmaStages;
    w_off = (size_t)slots * stage_rows * BN * sizeof(__nv_bfloat16);
    const size_t ring =
        w_off + (size_t)slots * R * kMmaKS * sizeof(__nv_bfloat16);
    const size_t red = (size_t)R * (BN + 4) * sizeof(float);
    table_off = ring > red ? ring : red;
    total = table_off + (size_t)(klen + R) * sizeof(int);
  }
};

// Class rows i0 .. i0+R-1 of class c and tokens n0 .. n0+kMmaBN-1, with
// c = blockIdx.x / tiles_per_class, i0 = R*(blockIdx.x % tiles_per_class),
// n0 = kMmaBN*blockIdx.y.  Class row i is row (i % G) of row group
// cls_groups[cls_start[c] + i / G]; every row of the class contracts its
// compact columns kk < len = n_chunks*C (walked to a whole k16 step,
// klen) against input rows xrow[kk] = cls_col0[c, kk/C] + kk%C of I, so
// the tile is one dense product of one staged I slice.  A block past its
// class's rows returns at once.
template <int R, int WM, int WK>
__global__ void __launch_bounds__(FmMma<R, WM, WK>::kThreads)
    rbgp4mm_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const int* __restrict__ cls_col0,
                       const int* __restrict__ cls_groups,
                       const int* __restrict__ cls_start,
                       __nv_bfloat16* __restrict__ out, int n_cols,
                       int n_chunks, int G, int C, int tiles_per_class) {
  using S = FmMma<R, WM, WK>;
  constexpr int BN = kMmaBN;
  using mma_bf16::swz;
  const int cls = blockIdx.x / tiles_per_class;
  const int first = cls_start[cls];
  const int rows = (cls_start[cls + 1] - first) * G;  // the class's rows
  const int i0 = (blockIdx.x % tiles_per_class) * R;
  if (i0 >= rows) return;  // the whole block: a smaller class
  const int len = n_chunks * C;
  const int klen = (len + 15) & ~15;
  const int n_steps = (klen + kMmaKS - 1) / kMmaKS;
  const FmSmem L(klen, R);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw + L.w_off);
  int* xrow = reinterpret_cast<int*>(smem_raw + L.table_off);
  int* orow = xrow + klen;

  const long long n0 = (long long)blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % WM;
  const int wk = warp / WM;
  const int* cols = cls_col0 + (long long)cls * n_chunks;

  for (int kk = tid; kk < klen; kk += S::kThreads) {
    int r = -1;
    if (kk < len) {
      const int s = kk / C;
      r = cols[s] + (kk - s * C);
    }
    xrow[kk] = r;
  }
  for (int i = tid; i < R; i += S::kThreads) {
    const int ci = i0 + i;
    orow[i] = ci < rows ? cls_groups[first + ci / G] * G + ci % G : -1;
  }
  __syncthreads();

  // stage `step`: its rows kk (a whole number of k16 steps, at most 64) of
  // I (x BN tokens) and of W (the R class rows x the same columns)
  auto load_stage = [&](int step, int slot) {
    __nv_bfloat16* xd = xs + slot * L.stage_rows * BN;
    __nv_bfloat16* wd = ws + slot * R * kMmaKS;
    const int kb = step * kMmaKS;
    const int n_rows = min(kMmaKS, klen - kb);
    for (int i = tid; i < n_rows * S::kXW; i += S::kThreads) {
      const int r = i / S::kXW, j = i % S::kXW;
      const int xr = xrow[kb + r];
      const long long n = n0 + j * 8;
      const bool ok = xr >= 0 && n < n_cols;
      const __nv_bfloat16* src = ok ? x + (long long)xr * n_cols + n : x;
      mma_bf16::cp_async16(xd + swz<S::kXW>(r, j), src, ok);
    }
    const int cw = n_rows / 8;  // chunks of a W row in this stage
    for (int i = tid; i < R * 8; i += S::kThreads) {
      const int r = i >> 3, j = i & 7;
      if (j >= cw) continue;
      const int kk = kb + j * 8;
      const int wr = orow[r];
      const bool ok = wr >= 0 && kk < len;
      const __nv_bfloat16* src = ok ? w + (long long)wr * len + kk : w;
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
    const __nv_bfloat16* xt = xs + slot * L.stage_rows * BN;
    const __nv_bfloat16* wt = ws + slot * R * kMmaKS;
    const int n_ks = min(kMmaKS, klen - step * kMmaKS) / 16;
    for (int ks = wk; ks < n_ks; ks += WK) {
      // A = I^T (16 tokens x 16 columns) of each m16 tile: matrices
      // (tokens 0-7, columns 0-7), (tokens 8-15, columns 0-7), (tokens
      // 0-7, columns 8-15), (tokens 8-15, columns 8-15), each read
      // transposed from the feature-major slice (rows = columns kk)
      uint32_t a[S::kMT][4];
#pragma unroll
      for (int i = 0; i < S::kMT; ++i) {
        const int r = ks * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int c = (wm * S::kTM + i * 16) / 8 + ((lane >> 3) & 1);
        mma_bf16::ldmatrix_x4_trans(a[i], xt + swz<S::kXW>(r, c));
      }
#pragma unroll
      for (int t = 0; t < S::kNT / 2; ++t) {
        // class rows t*16 .. +15 of W: matrices (rows 0-7, columns 0-7),
        // (rows 0-7, columns 8-15), (rows 8-15, columns 0-7), (rows 8-15,
        // columns 8-15) = b0, b1 of n8 tile 2t and of tile 2t+1
        uint32_t b[4];
        const int r = t * 16 + (lane & 7) + ((lane >> 4) << 3);
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
  __syncthreads();  // the ring is reused for the warps' sums

  // the warps' sums into an R x BN f32 tile in warp order wk = 0, 1, ...:
  // c0, c1 at (token lane/4, class rows 2*(lane%4) + {0, 1}), c2, c3 eight
  // tokens further
  float* red = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int p = 0; p < WK; ++p) {
    if (wk == p) {
#pragma unroll
      for (int i = 0; i < S::kMT; ++i)
#pragma unroll
        for (int t = 0; t < S::kNT; ++t)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int tok = wm * S::kTM + i * 16 + (lane >> 2) + ((q >> 1) << 3);
            const int row = t * 8 + (lane & 3) * 2 + (q & 1);
            float* d = red + row * S::kLD + tok;
            *d = p == 0 ? acc[i][t][q] : *d + acc[i][t][q];
          }
    }
    __syncthreads();
  }
  // 8 consecutive tokens of a row of O a thread, one 16-byte store, into
  // the class row's own place
  for (int c = tid; c < R * S::kXW; c += S::kThreads) {
    const int r = c / S::kXW, c8 = (c % S::kXW) * 8;
    const long long n = n0 + c8;
    const int row = orow[r];
    if (row < 0 || n >= n_cols) continue;
    const float* v = red + r * S::kLD + c8;
    *reinterpret_cast<uint4*>(out + (long long)row * n_cols + n) =
        make_uint4(mma_bf16::pack_bf16x2(v[0], v[1]),
                   mma_bf16::pack_bf16x2(v[2], v[3]),
                   mma_bf16::pack_bf16x2(v[4], v[5]),
                   mma_bf16::pack_bf16x2(v[6], v[7]));
  }
}

// The class tables of a launch (kernels/rbgp4mm.py:RowGroupClasses).
struct Classes {
  const int* col0;    // (n_classes, n_chunks)
  const int* groups;  // the row groups, class by class
  const int* start;   // (n_classes + 1)
  int n_classes, max_groups;
};

template <int R, int WM, int WK>
cudaError_t launch_mma_tile(const void* x, const void* w, const Classes& cl,
                            void* out, int n_cols, int n_chunks, int G,
                            int C, cudaStream_t stream) {
  using S = FmMma<R, WM, WK>;
  const int klen = (n_chunks * C + 15) & ~15;
  const size_t smem = FmSmem(klen, R).total;
  const long long tiles = (n_cols + kMmaBN - 1) / kMmaBN;
  const long long per_class = ((long long)cl.max_groups * G + R - 1) / R;
  if (smem > kMaxSmem || tiles > 65535 ||
      per_class * cl.n_classes > 2147483647LL)
    return cudaErrorInvalidValue;
  const auto kernel = rbgp4mm_mma_kernel<R, WM, WK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // class tiles fastest: the blocks of one token tile, which read
  // overlapping input rows, run together
  const dim3 grid((unsigned)(per_class * cl.n_classes), (unsigned)tiles);
  kernel<<<grid, S::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), cl.col0, cl.groups, cl.start,
      static_cast<__nv_bfloat16*>(out), n_cols, n_chunks, G, C,
      (int)per_class);
  return cudaGetLastError();
}

// The mma body: bf16 only, G in {8, 16, 32, 64}, C a multiple of 8, N a
// multiple of 8, x, w and out 16-byte aligned, one of the tiles of
// kernels/rbgp4mm.py:FM_MMA_TILES (rows, warps_m, warps_k), at most 65535
// token tiles; anything else is refused (the caller's path choice is
// wrong).
cudaError_t launch_mma(const void* x, const void* w, const Classes& cl,
                       void* out, int n_cols, int m, int n_chunks, int G,
                       int C, int rows, int wm, int wk,
                       cudaStream_t stream) {
  if (n_cols < 1 || n_cols % 8 != 0 || n_chunks < 1 || C < 8 ||
      C % 8 != 0 || (G != 8 && G != 16 && G != 32 && G != 64) ||
      m % G != 0 || m < G || cl.n_classes < 1 || cl.max_groups < 1 ||
      !mma_bf16::aligned16(x) || !mma_bf16::aligned16(w) ||
      !mma_bf16::aligned16(out) ||
      (long long)n_chunks * C > 2147483647LL - kMmaKS)
    return cudaErrorInvalidValue;
#define FM_TILE(R_, WM_, WK_)                                              \
  if (rows == R_ && wm == WM_ && wk == WK_)                                \
    return launch_mma_tile<R_, WM_, WK_>(x, w, cl, out, n_cols, n_chunks, G, \
                                         C, stream);
  FM_TILE(16, 4, 1)
  FM_TILE(16, 8, 1)
  FM_TILE(16, 2, 4)
  FM_TILE(32, 4, 1)
  FM_TILE(32, 8, 1)
  FM_TILE(32, 2, 4)
  FM_TILE(64, 4, 1)
#undef FM_TILE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out all of it).  x (K, N),
// w (M, n_chunks*C), col0 (M/G, n_chunks) int32, out (M, N), all
// contiguous.  path: 0 the FMA body, which reads col0; 1 the bf16
// tensor-core body (the caller's choice, kernels/rbgp4mm.py:fm_path),
// which reads col0's row-group classes instead (cls_col0 (n_classes,
// n_chunks), cls_groups (M/G), cls_start (n_classes + 1), int32; the
// largest class max_groups row groups) with the tile (rows, warps_m,
// warps_k) the caller names (kernels/rbgp4mm.py:fm_mma_tile).
// The FMA body ignores the classes and the tile.  Returns the cudaError_t
// of the launch.
extern "C" int rbgp4mm_launch(int dtype, const void* x, const void* w,
                              const void* col0, const void* cls_col0,
                              const void* cls_groups, const void* cls_start,
                              void* out, int n_cols, int m, int n_chunks,
                              int G, int C, int n_classes, int max_groups,
                              int path, int rows, int warps_m, int warps_k,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    const Classes cl{static_cast<const int*>(cls_col0),
                     static_cast<const int*>(cls_groups),
                     static_cast<const int*>(cls_start), n_classes,
                     max_groups};
    return (int)launch_mma(x, w, cl, out, n_cols, m, n_chunks, G, C, rows,
                           warps_m, warps_k, s);
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
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
