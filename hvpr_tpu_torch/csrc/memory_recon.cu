// Memory reconstruction for training: forward (kernel K6) and backward
// (kernel K7), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels hvpr_tpu/ops/memory_recon.py:141
// (`_recon_pallas_fwd`, `_fwd_kernel`) and :169 (`_recon_pallas_bwd`,
// `_bwd_kernel`). There W (2000 x 64) stays in VMEM for the whole grid, row
// blocks stream through, and the (rows, M) attention never leaves VMEM; the
// backward recomputes it and accumulates dW across a sequential grid.
//
// K6 hvpr_memory_recon_fwd, one kernel per block of 16 rows: the block's
// (16, M) logits live in shared memory (128 KB at M = 2000); the bf16
// memory streams through shared memory in 64-row chunks, twice: once for the
// logits, once for the output n W. Softmax, shrink and renorm run on the
// shared tile, one warp per row. Its products are f64 FMAs on the CUDA
// cores.
//
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
// that of bf16 tensor cores (989 TFLOP/s). K6 runs them as f64 FMAs on the
// CUDA cores; K7 on the FP64 tensor cores (67 TFLOP/s), which keeps the
// f64 sums that make kernel and plain version agree, at 1/15 of the bf16
// rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 64;
constexpr int kChunk = 64;              // K6: memory rows per shared chunk
constexpr int kWStride = kMaxC + 1;     // K6: padded f64 row of a chunk
constexpr int kFwdRows = 16;
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

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// memory rows [m0, m0 + kChunk) as f64 into ws (zeros past m and c)
__device__ void load_w_chunk(const __nv_bfloat16* __restrict__ w, double* ws,
                             int m0, int m, int c) {
  for (int i = threadIdx.x; i < kChunk * kMaxC; i += kThreads) {
    const int mm = i / kMaxC, cc = i % kMaxC;
    double v = 0.0;
    if (m0 + mm < m && cc < c) v = (double)to_f(w[(size_t)(m0 + mm) * c + cc]);
    ws[mm * kWStride + cc] = v;
  }
}

// `rows` rows of a bf16 (R, C) matrix from row0 as f64 (zeros past r and c)
__device__ void load_rows(const __nv_bfloat16* __restrict__ src, double* dst,
                          int row0, int rows, int r, int c) {
  for (int i = threadIdx.x; i < rows * kMaxC; i += kThreads) {
    const int rr = i / kMaxC, cc = i % kMaxC;
    double v = 0.0;
    if (row0 + rr < r && cc < c) v = (double)to_f(src[(size_t)(row0 + rr) * c + cc]);
    dst[rr * kMaxC + cc] = v;
  }
}

// L = x W^T for a shared (ROWS x m) tile L
template <int ROWS>
__device__ void logits_pass(const __nv_bfloat16* __restrict__ w, const double* xs,
                            float* L, double* ws, int m, int c) {
  constexpr int kPairs = ROWS * kChunk / kThreads;
  for (int m0 = 0; m0 < m; m0 += kChunk) {
    __syncthreads();
    load_w_chunk(w, ws, m0, m, c);
    __syncthreads();
    for (int k = 0; k < kPairs; ++k) {
      const int p = threadIdx.x + k * kThreads;
      const int rr = p / kChunk, mm = p % kChunk;
      if (m0 + mm >= m) continue;
      const double* wr = ws + mm * kWStride;
      const double* xr = xs + rr * kMaxC;
      double acc = 0.0;
      for (int cc = 0; cc < c; ++cc) acc = fma(xr[cc], wr[cc], acc);
      L[rr * m + m0 + mm] = (float)acc;
    }
  }
  __syncthreads();
}

// out[row0 + r, :] = T[r, :] W for a shared (rows x m) tile T of bf16 values
template <int ROWS>
__device__ void product_pass(const __nv_bfloat16* __restrict__ w, const float* T,
                             double* ws, float* __restrict__ out, int row0, int r,
                             int m, int c) {
  constexpr int kOuts = ROWS * kMaxC / kThreads;
  double acc[kOuts];
  for (int k = 0; k < kOuts; ++k) acc[k] = 0.0;
  for (int m0 = 0; m0 < m; m0 += kChunk) {
    __syncthreads();
    load_w_chunk(w, ws, m0, m, c);
    __syncthreads();
    const int mlen = min(kChunk, m - m0);
    for (int k = 0; k < kOuts; ++k) {
      const int o = threadIdx.x + k * kThreads;
      const int rr = o / kMaxC, cc = o % kMaxC;
      const float* tr = T + rr * m + m0;
      for (int mm = 0; mm < mlen; ++mm)
        acc[k] = fma((double)tr[mm], ws[mm * kWStride + cc], acc[k]);
    }
  }
  for (int k = 0; k < kOuts; ++k) {
    const int o = threadIdx.x + k * kThreads;
    const int rr = o / kMaxC, cc = o % kMaxC;
    if (row0 + rr < r && cc < c) out[(size_t)(row0 + rr) * c + cc] = (float)acc[k];
  }
}

// softmax of a row held in shared memory, in place; returns nothing, the
// row then holds a = e / sum(e)
__device__ void softmax_row(float* lr, int m, int lane) {
  float mx = -INFINITY;
  for (int j = lane; j < m; j += 32) mx = fmaxf(mx, lr[j]);
  mx = warp_max(mx);
  double se = 0.0;
  for (int j = lane; j < m; j += 32) {
    const float e = expf(__fsub_rn(lr[j], mx));
    lr[j] = e;
    se += (double)e;
  }
  const float sf = (float)warp_sum(se);
  for (int j = lane; j < m; j += 32) lr[j] = __fdiv_rn(lr[j], sf);
}

__device__ __forceinline__ float shrink(float a, float lam) {
  const float u = __fsub_rn(a, lam);
  return __fdiv_rn(__fmul_rn(fmaxf(u, 0.f), a), __fadd_rn(fabsf(u), kEps));
}

// ----------------------------------------------------------------- K6

__global__ void __launch_bounds__(kThreads)
recon_fwd_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 float* __restrict__ y, int r, int m, int c, float lam) {
  extern __shared__ double smem_d[];
  double* ws = smem_d;                                   // kChunk x kWStride
  double* xs = ws + kChunk * kWStride;                   // kFwdRows x kMaxC
  float* L = reinterpret_cast<float*>(xs + kFwdRows * kMaxC);   // kFwdRows x m
  const int row0 = blockIdx.x * kFwdRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_rows(x, xs, row0, kFwdRows, r, c);
  logits_pass<kFwdRows>(w, xs, L, ws, m, c);

  for (int rr = warp; rr < kFwdRows; rr += kWarps) {
    float* lr = L + rr * m;
    softmax_row(lr, m, lane);
    if (lam > 0.f) {
      double st = 0.0;
      for (int j = lane; j < m; j += 32) {
        const float s = shrink(lr[j], lam);
        lr[j] = s;
        st += (double)s;
      }
      const float t = fmaxf((float)warp_sum(st), kDelta);
      for (int j = lane; j < m; j += 32) lr[j] = round_bf16(__fdiv_rn(lr[j], t));
    } else {
      for (int j = lane; j < m; j += 32) lr[j] = round_bf16(lr[j]);
    }
  }
  product_pass<kFwdRows>(w, L, ws, y, row0, r, m, c);
}

// ----------------------------------------------------------------- K7

// D (8 x 8) += A (8 x 4) B (4 x 8) on the FP64 tensor cores. Per lane:
// a = A[lane / 4][lane % 4], b = B[lane % 4][lane / 4], and
// d0, d1 = D[lane / 4][2 (lane % 4) + {0, 1}].
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

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

__device__ __forceinline__ double widen(__nv_bfloat16 v) { return (double)to_f(v); }

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

size_t fwd_smem(int m) {
  return sizeof(double) * (kChunk * kWStride + kFwdRows * kMaxC) + sizeof(float) * kFwdRows * m;
}

constexpr size_t kLogitsSmem = sizeof(double) * (kLRows + kLMem) * kLStride;
constexpr size_t kDxSmem = sizeof(double) * (kXRows * kXAStride + kXK * kCStride);
constexpr size_t kDwSmem = sizeof(double) * 2 * kDwK * (kDwAStride + kCStride);

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int hvpr_memory_recon_fwd(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                     float* y, int r, int m, int c, float lam,
                                     void* stream) {
  const size_t smem = fwd_smem(m);
  cudaError_t err = allow_smem(recon_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (r + kFwdRows - 1) / kFwdRows;
  recon_fwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(x, w, y, r, m, c, lam);
  return (int)cudaGetLastError();
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
