// Memory reconstruction for training: forward (kernel K6) and backward
// (kernel K7), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels hvpr_tpu/ops/memory_recon.py:141
// (`_recon_pallas_fwd`, `_fwd_kernel`) and :169 (`_recon_pallas_bwd`,
// `_bwd_kernel`). There W (2000 x 64) stays in VMEM for the whole grid, row
// blocks stream through, and the (rows, M) attention never leaves VMEM; the
// backward recomputes it and accumulates dW across a sequential grid.
//
// K6 hvpr_memory_recon_fwd, one kernel, a block of 16 warps owning 16 rows,
// K2's layout (memory_lookup.cu) carried over:
//   sweep: the logits x W^T on the FP64 tensor cores (mma.sync m8n8k4 .f64,
//     DMMA). W streams through shared memory as bf16 in 128-row chunks
//     (rows padded to 144 B), double-buffered with cp.async, and each W
//     fragment is widened to f64 as it is loaded; a warp owns the 16 rows x
//     8 columns of each chunk, its x fragments in registers for the whole
//     sweep. The logits, rounded to f32, fill a shared tile of 16 x (Mp + 8)
//     f32 (129 KB at M = 2000).
//   row chain: a warp a row, softmax, shrink and renorm on the tile in the
//     plain version's f32 IEEE operations and order, with f64 row sums, in
//     three passes; a weight that the shrink sets to zero skips its
//     divisions (most of them: with seeded random weights, 86% of the rows
//     at hvpr.yaml keep none). The tile then holds n = bf16(renorm(shrink(a))) and each row
//     its count of nonzero weights.
//   output n W: a weight is nonzero only where a > lam, and the a of a row
//     sum to 1, so a row has fewer than 1/lam of them (400 at hvpr.yaml's
//     lam = 0.0025). Each row lists its nonzero columns in index order
//     (ballots; indices in the free chunk buffers, weights compacted in
//     place in the tile) and a warp sums bf16(n) bf16(W) over the list in
//     f64, lanes over channels, the W rows read from L2 with 8 rows' loads
//     in flight. A tile in which a row lists more than kFCap = 512 columns,
//     and every tile at lam = 0 (n = a is dense), takes a second sweep over
//     W instead, n W on DMMA (a warp an 8 x 8 output tile). kFCap = 512 puts
//     every row of a lam >= 1/512 on the list path.
// K7 hvpr_memory_recon_bwd runs its five products (l = x W^T, dn = dy W^T,
// dx = dl W, dW = dl^T x + n^T dy) on the FP64 tensor cores
// (mma.sync.aligned.m8n8k4 .f64, DMMA), as block tiles of 64-128 rows, so
// each block widens W once for 64-128 rows instead of twice for 8. A row's
// softmax needs all M logits, and a 64-row tile of l and dn (2 x 512 KB in
// f32 at M = 2000) does not fit a block's 227 KB of shared memory, so the
// tiles meet through device memory, in five launches:
//   (a) l and dn as f32 (2 x R x M, 2 x 524 MB at hvpr.yaml's R = 65,536):
//       a block owns 64 rows x 128 memory rows with K = C = 64 in one
//       shared tile (blockIdx.z picks x or dy);
//   (b) the per-row chain of the docstring of ops/memory_recon.py, a block
//       a row with the row's l and dn in registers (12 elements a thread)
//       and block-wide f64 row sums; it writes bf16 n and dl (R x M each);
//   (c) dx = dl W: a block owns 128 rows x C and walks M in 32-wide chunks;
//   (d) dW = dl^T x + n^T dy: a block owns 128 memory rows x C over one
//       split of the rows, walked in 32-row chunks in a fixed order into an
//       f64 partial;
//   (e) the partials summed over the splits in a fixed order.
// Writing l and dn and reading them back moves ~2.1 GB (~0.6 ms at 3.35
// TB/s), against the 28 ms that an 8-row tile with W in shared memory spent
// on CUDA-core f64 FMAs. Blocks run in no order on Hopper, so dW cannot be
// carried across blocks as the TPU grid carries it; the partials keep it
// deterministic, with no float atomics.
//
// Numerics: every product takes bf16 inputs (x, W, dy, n, dl), as the JAX
// package's do, widened exactly to f64; sums of products and the row sums
// accumulate in f64 (bf16 products are exact in f64, and so are their sums
// here, so their order does not matter) and round to f32 once; softmax,
// shrink and renorm are f32 IEEE operations written as intrinsics in the
// plain version's order (no FMA contraction). The plain versions in
// ops/memory_recon.py do the same, so the two agree to the last bit but for
// a rare order-dependent last f64 bit.
//
// Bound: operations. K6 is 2 and K7 5 products of R x M x C multiply-adds
// (R = 65,536 rows, M = 2000, C = 64 at hvpr.yaml batch 4), whose bound is
// that of bf16 tensor cores (989 TFLOP/s). Both run them on the FP64 tensor
// cores (67 TFLOP/s), which keeps the f64 sums that make kernel and plain
// version agree, at 1/15 of the bf16 rate; K6's second product touches
// only the nonzero weights (list path), so its DMMA bound is that of the
// logits, 2 R M C / 67e12 = 0.25 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "dmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 64;
constexpr float kEps = 1e-12f;
constexpr float kDelta = 1e-12f;

// K7 tiles. A shared f64 tile stores element (row, k) at row * S + k
// ("k-contiguous") or at k * S + row; with S = 4 (mod 16) both ways give the
// 16 lanes of a half-warp 16 distinct banks when they read an mma fragment.
constexpr int kLRows = 64;              // (a): rows x memory rows, K = C
constexpr int kLMem = 128;
constexpr int kLStride = kMaxC + 4;
constexpr int kChainThreads = 256;      // (b): a block a row,
constexpr int kChainPer = 12;           //      up to 12 elements a thread (M <= 3072)
constexpr int kXRows = 128;             // (c): rows per block, all of C
constexpr int kXK = 32;                 //      memory rows per chunk
constexpr int kXAStride = kXK + 4;
constexpr int kMem = 128;               // (d): memory rows per block
constexpr int kDwK = 32;                //      rows per chunk
constexpr int kDwAStride = kMem + 4;
constexpr int kCStride = kMaxC + 4;     // (c), (d): a chunk's C-wide rows

// K6 tiles
constexpr int kFRows = 16;              // rows a block
constexpr int kFWarps = 16;             // a warp a row in the row chain
constexpr int kFThreads = 32 * kFWarps;
constexpr int kFChunk = 128;            // W rows a chunk
constexpr int kFWCols = kFChunk / kFWarps;      // a warp's columns of a chunk: 8
constexpr int kFKSteps = kMaxC / 4;     // mma k-steps at most
constexpr int kFCS = kMaxC + 8;         // bf16 row stride of a chunk (144 B)
constexpr int kFChunkElems = kFChunk * kFCS;
constexpr int kFLPad = 8;               // f32 pad of a logit row
constexpr int kFCap = 512;              // nonzero weights a row's list holds
constexpr int kFAhead = 8;              // list rows whose loads are in flight
constexpr unsigned kFull = 0xffffffffu;

static_assert(kFRows == 16 && kFWCols == 8 && kFWarps == kFRows, "K6's warp tiles");
static_assert(kFRows * kFCap * 4 <= 2 * kFChunkElems * 2,
              "the lists' indices fit the chunk buffers");

using hvpr::bf16_round;
using hvpr::dmma;
using hvpr::widen;

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the softmax numerators of a row held in shared memory, in place: the
// row then holds e = exp(l - max l); returns sum(e), summed in f64
__device__ float softmax_numerators(float* lr, int m, int lane) {
  float mx = -INFINITY;
  for (int j = lane; j < m; j += 32) mx = fmaxf(mx, lr[j]);
  mx = warp_max(mx);
  double se = 0.0;
  for (int j = lane; j < m; j += 32) {
    const float e = expf(__fsub_rn(lr[j], mx));
    lr[j] = e;
    se += (double)e;
  }
  return (float)warp_sum(se);
}

__device__ __forceinline__ float shrink(float a, float lam) {
  const float u = __fsub_rn(a, lam);
  return __fdiv_rn(__fmul_rn(fmaxf(u, 0.f), a), __fadd_rn(fabsf(u), kEps));
}

// ----------------------------------------------------------------- K6

// out[0..C) += the list's bf16 weights lv times the W rows li, in list
// order; lanes over channels, kFAhead rows' loads in flight
__device__ __forceinline__ void output_from_list(const __nv_bfloat16* __restrict__ w,
                                                 const int* li, const float* lv, int cnt,
                                                 int C, int lane, double& a0, double& a1) {
  for (int e0 = 0; e0 < cnt; e0 += kFAhead) {
    float wt[kFAhead];
    __nv_bfloat16 m0[kFAhead], m1[kFAhead];
#pragma unroll
    for (int u = 0; u < kFAhead; ++u) {
      const int e = min(e0 + u, cnt - 1);
      wt[u] = e0 + u < cnt ? lv[e] : 0.0f;
      const __nv_bfloat16* wr = w + (size_t)li[e] * C;
      m0[u] = wr[lane < C ? lane : 0];
      m1[u] = wr[lane + 32 < C ? lane + 32 : 0];
    }
#pragma unroll
    for (int u = 0; u < kFAhead; ++u) {
      if (e0 + u < cnt) {
        a0 = fma((double)wt[u], widen(m0[u]), a0);
        a1 = fma((double)wt[u], widen(m1[u]), a1);
      }
    }
  }
}

// stop = 0 runs all of it; 1 ends after the sweep and 2 after the row chain
// (to time the parts; those runs leave y undefined)
__global__ void __launch_bounds__(kFThreads, 1)
recon_fwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 float* __restrict__ y, int r, int m, int c, float lam, int stop) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Mp = (m + kFChunk - 1) / kFChunk * kFChunk;
  const int n_chunks = Mp / kFChunk;
  const int LS = Mp + kFLPad;
  __nv_bfloat16* chunks = reinterpret_cast<__nv_bfloat16*>(smem);    // 2 x kFChunkElems
  float* L = reinterpret_cast<float*>(chunks + 2 * kFChunkElems);    // kFRows x LS
  int* counts = reinterpret_cast<int*>(L + kFRows * LS);             // kFRows
  int* lidx = reinterpret_cast<int*>(smem);         // kFRows x kFCap, after the sweep
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.x * kFRows;

  hvpr::stage_rows<kFChunk, kFCS, kFThreads>(w, chunks, 0, m, c);

  // 1. the warp's x fragments, widened: a[i][ks] = x[row0 + 8 i + g][4 ks + q]
  //    (zero past r)
  const int ksteps = c / 4;
  double a[2][kFKSteps];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8 + g;
#pragma unroll
    for (int ks = 0; ks < kFKSteps; ++ks)
      a[i][ks] = row < r && ks < ksteps ? widen(x[(size_t)row * c + ks * 4 + q]) : 0.0;
  }

  // 2. the sweep: the logits of the warp's 16 rows x 8 columns of each
  //    chunk on DMMA, rounded to f32 into the tile (columns past m: W's zero
  //    rows give 0, never read)
  const int wc = warp * kFWCols;
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      hvpr::stage_rows<kFChunk, kFCS, kFThreads>(
          w, chunks + ((ch + 1) & 1) * kFChunkElems, (ch + 1) * kFChunk, m, c);
      hvpr::cp_async_wait<1>();
    } else {
      hvpr::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cb = chunks + (ch & 1) * kFChunkElems;
    double acc[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
    for (int ks = 0; ks < kFKSteps; ++ks) {
      if (ks < ksteps) {
        const double b = widen(cb[(wc + g) * kFCS + ks * 4 + q]);
#pragma unroll
        for (int i = 0; i < 2; ++i) dmma(acc[i][0], acc[i][1], a[i][ks], b);
      }
    }
    const int col = ch * kFChunk + wc + 2 * q;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(L + (i * 8 + g) * LS + col) =
          make_float2(__double2float_rn(acc[i][0]), __double2float_rn(acc[i][1]));
    __syncthreads();                    // the buffer is refilled next round
  }
  if (stop == 1) {
    if (threadIdx.x < kFRows && row0 + threadIdx.x < r)
      y[(size_t)(row0 + threadIdx.x) * c] = L[threadIdx.x * LS];
    return;
  }

  // 3. the row chain, a warp a row: n = bf16(renorm(shrink(softmax(l)))) in
  //    place (zeros past m) and the row's count of nonzero weights. Where
  //    u = a - lam <= 0 the shrunk weight s is +0 (relu(u) a / ...), and so
  //    is n = s / t (t >= delta > 0): those elements skip the divisions,
  //    most of a row at lam = 0.0025. An e below e_lo, an f32 product that
  //    is below lam sum(e) (its two roundings are far inside the factor
  //    1 - 1e-6), has e / sum(e) < lam and so a = rn(e / sum(e)) <= lam:
  //    it skips a's division too.
  const int rr = warp;
  float* lr = L + rr * LS;
  int cnt = 0;
  if (row0 + rr < r) {
    const float sf = softmax_numerators(lr, m, lane);
    float t = 0.f;
    if (lam > 0.f) {
      const float e_lo = __fmul_rn(__fmul_rn(lam, sf), 0.999999f);
      double st = 0.0;
      for (int j = lane; j < m; j += 32) {
        const float e = lr[j];
        float s = 0.f;
        if (e >= e_lo) {
          const float a = __fdiv_rn(e, sf);
          if (__fsub_rn(a, lam) > 0.f) s = shrink(a, lam);
        }
        lr[j] = s;
        st += (double)s;
      }
      t = fmaxf((float)warp_sum(st), kDelta);
    }
    for (int j0 = 0; j0 < Mp; j0 += 32) {
      const int j = j0 + lane;
      float n = 0.f;
      if (j < m) {
        const float v = lr[j];          // s when lam > 0, else e
        n = lam > 0.f ? (v != 0.f ? bf16_round(__fdiv_rn(v, t)) : 0.f)
                      : bf16_round(__fdiv_rn(v, sf));
      }
      lr[j] = n;
      cnt += __popc(__ballot_sync(kFull, n != 0.0f));
    }
  } else {
    for (int j = lane; j < Mp; j += 32) lr[j] = 0.0f;
  }
  if (lane == 0) counts[rr] = cnt;
  __syncthreads();
  if (stop == 2) {
    if (lane == 0 && row0 + rr < r) y[(size_t)(row0 + rr) * c] = lr[0];
    return;
  }
  bool dense = !(lam > 0.f);
  for (int i = 0; i < kFRows; ++i) dense = dense || counts[i] > kFCap;

  if (!dense) {
    // 4a. the list path: a warp a row, the nonzero columns in index order
    //     (weights compacted in place: a column's list position is at most
    //     its index, and the warp has read its 32 columns before the ballot)
    if (row0 + rr >= r) return;
    int* li = lidx + rr * kFCap;
    const unsigned below = (1u << lane) - 1u;
    int pos = 0;
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const float wv = j < m ? lr[j] : 0.0f;
      const unsigned ball = __ballot_sync(kFull, wv != 0.0f);
      if (wv != 0.0f) {
        const int p = pos + __popc(ball & below);
        li[p] = j;
        lr[p] = wv;
      }
      pos += __popc(ball);
    }
    __syncwarp();
    double a0 = 0.0, a1 = 0.0;
    output_from_list(w, li, lr, cnt, c, lane, a0, a1);
    float* yr = y + (size_t)(row0 + rr) * c;
    if (lane < c) yr[lane] = __double2float_rn(a0);
    if (lane + 32 < c) yr[lane + 32] = __double2float_rn(a1);
    return;
  }

  // 4b. the dense path: n W on DMMA in a second sweep over W; warp w owns
  //     output rows 8 (w % 2).. and channels 8 (w / 2).. (none when past c)
  const int rt = warp & 1, ct = warp >> 1;
  const bool active = ct * 8 < c;
  double d0 = 0.0, d1 = 0.0;
  hvpr::stage_rows<kFChunk, kFCS, kFThreads>(w, chunks, 0, m, c);
  const float* nrow = L + (rt * 8 + g) * LS;
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      hvpr::stage_rows<kFChunk, kFCS, kFThreads>(
          w, chunks + ((ch + 1) & 1) * kFChunkElems, (ch + 1) * kFChunk, m, c);
      hvpr::cp_async_wait<1>();
    } else {
      hvpr::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cb = chunks + (ch & 1) * kFChunkElems;
    if (active) {
#pragma unroll 8
      for (int kk = 0; kk < kFChunk; kk += 4)
        dmma(d0, d1, (double)nrow[ch * kFChunk + kk + q], widen(cb[(kk + q) * kFCS + ct * 8 + g]));
    }
    __syncthreads();
  }
  const int row = row0 + rt * 8 + g, col = ct * 8 + 2 * q;
  if (active && row < r) {
    if (col < c) y[(size_t)row * c + col] = __double2float_rn(d0);
    if (col + 1 < c) y[(size_t)row * c + col + 1] = __double2float_rn(d1);
  }
}

// ----------------------------------------------------------------- K7

// A warp's (TM * 8) x (TN * 8) tile of D += A B^T over k_steps * 4 of K, from
// shared f64 tiles: A's rows a_row0.., B's rows (D's columns) b_row0..;
// A_KC / B_KC say whether a tile is k-contiguous (see kLStride).
template <int TM, int TN, bool A_KC, int SA, bool B_KC, int SB>
__device__ __forceinline__ void warp_mma(const double* A, const double* B, int a_row0,
                                         int b_row0, int k_steps, double (&acc)[TM][TN][2],
                                         int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 2
  for (int ks = 0; ks < k_steps; ++ks) {
    const int k = ks * 4 + q;
    double a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = a_row0 + i * 8 + g;
      a[i] = A_KC ? A[row * SA + k] : A[k * SA + row];
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int row = b_row0 + j * 8 + g;
      b[j] = B_KC ? B[row * SB + k] : B[k * SB + row];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) dmma(acc[i][j][0], acc[i][j][1], a[i], b[j]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(double (&acc)[TM][TN][2]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
}

// A (ROWS x COLS) tile of a row-major bf16 matrix, rows row0.. (< row_end)
// and columns col0.. (< col_end) of row stride ld, widened into a shared f64
// tile at dst[rr * SR + cc] (zeros past the ends); neighbouring threads on
// neighbouring columns.
template <int ROWS, int COLS, int SR>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src, double* dst,
                                          int row0, int row_end, int col0, int col_end,
                                          int ld) {
  for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
    const int rr = i / COLS, cc = i % COLS;
    dst[rr * SR + cc] = row0 + rr < row_end && col0 + cc < col_end
        ? widen(src[(size_t)(row0 + rr) * ld + col0 + cc])
        : 0.0;
  }
}

// (a) ld[z] = (z ? dy : x) W^T as f32, (R, M) each
__global__ void __launch_bounds__(kThreads, 2)
bwd_logits_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                  const __nv_bfloat16* __restrict__ w, float* __restrict__ ld, int r,
                  int m, int c) {
  extern __shared__ double smem_d[];
  double* As = smem_d;                                  // kLRows x kLStride
  double* Bs = As + kLRows * kLStride;                  // kLMem x kLStride
  const __nv_bfloat16* src = blockIdx.z ? dy : x;
  float* out = ld + (size_t)blockIdx.z * r * m;
  const int m0 = blockIdx.x * kLMem, row0 = blockIdx.y * kLRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_tile<kLRows, kMaxC, kLStride>(src, As, row0, r, 0, c, c);
  load_tile<kLMem, kMaxC, kLStride>(w, Bs, m0, m, 0, c, c);
  __syncthreads();

  const int wr = (warp >> 2) * 32, wc = (warp & 3) * 32;   // 2 x 4 warps of 32 x 32
  double acc[4][4][2];
  zero(acc);
  warp_mma<4, 4, true, kLStride, true, kLStride>(As, Bs, wr, wc, (c + 3) / 4, acc, lane);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + wr + i * 8 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = m0 + wc + j * 8 + 2 * (lane & 3);
      float* o = out + (size_t)row * m + col;
      if (row >= r || col >= m) continue;
      if ((m & 1) == 0) {               // col is even: both columns, 8 bytes
        *reinterpret_cast<float2*>(o) = make_float2((float)acc[i][j][0], (float)acc[i][j][1]);
      } else {
        o[0] = (float)acc[i][j][0];
        if (col + 1 < m) o[1] = (float)acc[i][j][1];
      }
    }
  }
}

// block-wide reductions: every thread gets the same result, summed in the
// same order (warps by butterfly, then the warps' partials in warp order)
__device__ __forceinline__ float block_max(float v, float* sh) {
  v = warp_max(v);
  __syncthreads();                                     // sh free again
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = sh[0];
  for (int k = 1; k < kChainThreads / 32; ++k) t = fmaxf(t, sh[k]);
  return t;
}

__device__ __forceinline__ double block_sum(double v, double* sh) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  for (int k = 0; k < kChainThreads / 32; ++k) t += sh[k];
  return t;
}

// (b) the per-row chain from the row's logits and dn: n and dl as bf16. A
// block owns a row and each thread the elements j = tid + 256 k in
// registers, so the row never goes through shared memory.
__global__ void __launch_bounds__(kChainThreads)
bwd_chain_kernel(const float* __restrict__ ld, __nv_bfloat16* __restrict__ dl_out,
                 __nv_bfloat16* __restrict__ n_out, int r, int m, float lam) {
  __shared__ double shd[kChainThreads / 32];
  __shared__ float shf[kChainThreads / 32];
  const size_t g = (size_t)blockIdx.x * m;
  float a[kChainPer], dr[kChainPer];                 // logits, then a; dn, then da
#pragma unroll
  for (int k = 0; k < kChainPer; ++k) {
    const int j = threadIdx.x + k * kChainThreads;
    a[k] = j < m ? ld[g + j] : -INFINITY;
    dr[k] = j < m ? ld[(size_t)r * m + g + j] : 0.f;
  }
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < kChainPer; ++k) mx = fmaxf(mx, a[k]);
  mx = block_max(mx, shf);
  double se = 0.0;
#pragma unroll
  for (int k = 0; k < kChainPer; ++k) {
    if (threadIdx.x + k * kChainThreads < m) {
      a[k] = expf(__fsub_rn(a[k], mx));
      se += (double)a[k];
    }
  }
  const float sf = (float)block_sum(se, shd);
#pragma unroll
  for (int k = 0; k < kChainPer; ++k) a[k] = __fdiv_rn(a[k], sf);
  if (lam > 0.f) {
    double st = 0.0, dot = 0.0;
    // where u = a - lam <= 0 the shrunk weight s is +0 (relu(u) a / ...):
    // it adds nothing to these sums, and below n = s / t is +0 and
    // da = ds * 0 a zero (of ds's sign, which no later sum or product can
    // tell apart), so those elements skip the divisions
#pragma unroll
    for (int k = 0; k < kChainPer; ++k) {
      if (threadIdx.x + k * kChainThreads < m && __fsub_rn(a[k], lam) > 0.f) {
        const float s = shrink(a[k], lam);
        st += (double)s;
        dot += (double)dr[k] * (double)s;
      }
    }
    const float t_raw = (float)block_sum(st, shd);
    const float dotf = (float)block_sum(dot, shd);
    const float t = fmaxf(t_raw, kDelta);
    const float c1 = t_raw > kDelta ? __fdiv_rn(dotf, __fmul_rn(t, t)) : 0.f;
#pragma unroll
    for (int k = 0; k < kChainPer; ++k) {
      const int j = threadIdx.x + k * kChainThreads;
      if (j >= m) continue;
      const float u = __fsub_rn(a[k], lam);
      float nv = 0.f, da = 0.f;
      if (u > 0.f) {
        nv = __fdiv_rn(shrink(a[k], lam), t);
        const float ds = __fsub_rn(__fdiv_rn(dr[k], t), c1);
        const float d = __fadd_rn(u, kEps);
        const float gp = __fsub_rn(__fdiv_rn(__fadd_rn(a[k], u), d),
                                   __fdiv_rn(__fmul_rn(u, a[k]), __fmul_rn(d, d)));
        da = __fmul_rn(ds, gp);
      }
      n_out[g + j] = __float2bfloat16_rn(nv);
      dr[k] = da;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChainPer; ++k) {
      const int j = threadIdx.x + k * kChainThreads;
      if (j < m) n_out[g + j] = __float2bfloat16_rn(a[k]);
    }
  }
  double s2 = 0.0;
#pragma unroll
  for (int k = 0; k < kChainPer; ++k)
    if (threadIdx.x + k * kChainThreads < m) s2 += (double)dr[k] * (double)a[k];
  const float s2f = (float)block_sum(s2, shd);
#pragma unroll
  for (int k = 0; k < kChainPer; ++k) {
    const int j = threadIdx.x + k * kChainThreads;
    if (j < m) dl_out[g + j] = __float2bfloat16_rn(__fmul_rn(a[k], __fsub_rn(dr[k], s2f)));
  }
}

// (c) dx = dl W, (R, C) f32
__global__ void __launch_bounds__(kThreads, 2)
bwd_dx_kernel(const __nv_bfloat16* __restrict__ dl, const __nv_bfloat16* __restrict__ w,
              float* __restrict__ dx, int r, int m, int c) {
  extern __shared__ double smem_d[];
  double* As = smem_d;                                  // kXRows x kXAStride, dl
  double* Bs = As + kXRows * kXAStride;                 // kXK x kCStride, W
  const int row0 = blockIdx.x * kXRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;   // 4 x 2 warps of 32 x 32
  double acc[4][4][2];
  zero(acc);
  for (int m0 = 0; m0 < m; m0 += kXK) {
    __syncthreads();
    load_tile<kXRows, kXK, kXAStride>(dl, As, row0, r, m0, m, m);
    load_tile<kXK, kMaxC, kCStride>(w, Bs, m0, m, 0, c, c);
    __syncthreads();
    warp_mma<4, 4, true, kXAStride, false, kCStride>(As, Bs, wr, wc, kXK / 4, acc, lane);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + wr + i * 8 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wc + j * 8 + 2 * (lane & 3) + e;
        if (row < r && col < c) dx[(size_t)row * c + col] = (float)acc[i][j][e];
      }
  }
}

// (d) partial[split] = dl^T x + n^T dy over the split's rows, (M, C) f64
__global__ void __launch_bounds__(kThreads, 2)
bwd_dw_kernel(const __nv_bfloat16* __restrict__ dl, const __nv_bfloat16* __restrict__ n,
              const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
              double* __restrict__ partial, int r, int m, int c, int rows_per_split) {
  extern __shared__ double smem_d[];
  double* A1 = smem_d;                                  // kDwK x kDwAStride, dl
  double* A2 = A1 + kDwK * kDwAStride;                  // n
  double* B1 = A2 + kDwK * kDwAStride;                  // kDwK x kCStride, x
  double* B2 = B1 + kDwK * kCStride;                    // dy
  const int m0 = blockIdx.x * kMem;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(r, r_begin + rows_per_split);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;   // 4 x 2 warps of 32 x 32
  double acc[4][4][2];
  zero(acc);
  for (int rs = r_begin; rs < r_end; rs += kDwK) {
    __syncthreads();
    load_tile<kDwK, kMem, kDwAStride>(dl, A1, rs, r_end, m0, m, m);
    load_tile<kDwK, kMem, kDwAStride>(n, A2, rs, r_end, m0, m, m);
    load_tile<kDwK, kMaxC, kCStride>(x, B1, rs, r_end, 0, c, c);
    load_tile<kDwK, kMaxC, kCStride>(dy, B2, rs, r_end, 0, c, c);
    __syncthreads();
    warp_mma<4, 4, false, kDwAStride, false, kCStride>(A1, B1, wr, wc, kDwK / 4, acc, lane);
    warp_mma<4, 4, false, kDwAStride, false, kCStride>(A2, B2, wr, wc, kDwK / 4, acc, lane);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mm = m0 + wr + i * 8 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = wc + j * 8 + 2 * (lane & 3) + e;
        if (mm < m && cc < c) partial[((size_t)split * m + mm) * c + cc] = acc[i][j][e];
      }
  }
}

// (e) dW = the sum of the partials over the splits, in split order
__global__ void recon_dw_reduce_kernel(const double* __restrict__ partial,
                                       float* __restrict__ dw, int count, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  double s = 0.0;
  for (int k = 0; k < splits; ++k) s += partial[(size_t)k * count + i];
  dw[i] = (float)s;
}


constexpr size_t kLogitsSmem = sizeof(double) * (kLRows + kLMem) * kLStride;
constexpr size_t kDxSmem = sizeof(double) * (kXRows * kXAStride + kXK * kCStride);
constexpr size_t kDwSmem = sizeof(double) * 2 * kDwK * (kDwAStride + kCStride);

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// shared memory a K6 block needs for M memory rows
extern "C" long long hvpr_memory_recon_fwd_smem(int m) {
  const int Mp = (m + kFChunk - 1) / kFChunk * kFChunk;
  return 2LL * kFChunkElems * 2 + 4LL * kFRows * (Mp + kFLPad) + 4LL * kFRows;
}

// nonzero weights a row's list holds (a tile with a longer row, or lam = 0,
// takes the dense output path)
extern "C" int hvpr_memory_recon_fwd_cap() { return kFCap; }

// K6 run to the end of one of its parts: stop = 1 the sweep, 2 the row
// chain, 0 all of it (y is defined only then). x (R, C), w (M, C) bf16,
// y (R, C) f32; C % 8 == 0, C <= 64.
extern "C" int hvpr_memory_recon_fwd_part(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                          float* y, int r, int m, int c, float lam, int stop,
                                          void* stream) {
  const size_t smem = (size_t)hvpr_memory_recon_fwd_smem(m);
  cudaError_t err = allow_smem(recon_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (r + kFRows - 1) / kFRows;
  recon_fwd_kernel<<<blocks, kFThreads, smem, (cudaStream_t)stream>>>(x, w, y, r, m, c, lam,
                                                                      stop);
  return (int)cudaGetLastError();
}

extern "C" int hvpr_memory_recon_fwd(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                     float* y, int r, int m, int c, float lam,
                                     void* stream) {
  return hvpr_memory_recon_fwd_part(x, w, y, r, m, c, lam, 0, stream);
}

// ld: (2, R, M) f32 scratch for l and dn; dl, n: (R, M) bf16 scratch;
// partial: (splits, M, C) f64 scratch. Returns the first CUDA error.
extern "C" int hvpr_memory_recon_bwd(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                     const __nv_bfloat16* dy, float* dx, float* ld,
                                     __nv_bfloat16* dl, __nv_bfloat16* n,
                                     double* partial, float* dw, int r, int m, int c,
                                     float lam, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (m > kChainThreads * kChainPer) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = allow_smem(bwd_logits_kernel, kLogitsSmem)) != cudaSuccess ||
      (err = allow_smem(bwd_dx_kernel, kDxSmem)) != cudaSuccess ||
      (err = allow_smem(bwd_dw_kernel, kDwSmem)) != cudaSuccess)
    return (int)err;

  const dim3 lgrid((m + kLMem - 1) / kLMem, (r + kLRows - 1) / kLRows, 2);
  bwd_logits_kernel<<<lgrid, kThreads, kLogitsSmem, s>>>(x, dy, w, ld, r, m, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  bwd_chain_kernel<<<r, kChainThreads, 0, s>>>(ld, dl, n, r, m, lam);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  bwd_dx_kernel<<<(r + kXRows - 1) / kXRows, kThreads, kDxSmem, s>>>(dl, w, dx, r, m, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int rows_per_split = (r + splits - 1) / splits;
  const dim3 wgrid((m + kMem - 1) / kMem, splits);
  bwd_dw_kernel<<<wgrid, kThreads, kDwSmem, s>>>(dl, n, x, dy, partial, r, m, c,
                                                  rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int count = m * c;
  recon_dw_reduce_kernel<<<(count + 255) / 256, 256, 0, s>>>(partial, dw, count, splits);
  return (int)cudaGetLastError();
}
