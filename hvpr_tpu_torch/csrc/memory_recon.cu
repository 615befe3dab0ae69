// Memory reconstruction for training: forward (kernel K6) and backward
// (kernel K7), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels hvpr_tpu/ops/memory_recon.py:141
// (`_recon_pallas_fwd`, `_fwd_kernel`) and :169 (`_recon_pallas_bwd`,
// `_bwd_kernel`). There W (2000 x 64) stays in VMEM for the whole grid, row
// blocks stream through, and the (rows, M) attention never leaves VMEM; the
// backward recomputes it and accumulates dW across a sequential grid.
//
// Here, per block of rows:
//   K6  hvpr_memory_recon_fwd: one kernel. The block's (16, M) logits live
//       in shared memory (128 KB at M = 2000); the bf16 memory streams
//       through shared memory in 64-row chunks, twice: once for the logits,
//       once for the output n W. Softmax, shrink and renorm run on the
//       shared tile, one warp per row.
//   K7  hvpr_memory_recon_bwd: three kernels. (a) a row pass over blocks of
//       8 rows holding the attention and dn tiles (2 x 64 KB) in shared
//       memory: logits and dn = dy W^T in one pass over W, the per-row chain
//       of the docstring of ops/memory_recon.py, then dx = dl W in a second
//       pass over W; it writes bf16 dl and n (R x M each) for (b). (b) dW =
//       dl^T x + n^T dy: a block owns 32 memory rows x C over one split of
//       the rows and walks that split in a fixed order into an f64 partial.
//       (c) sums the partials over the splits in a fixed order. Blocks run
//       in no order on Hopper, so dW cannot be carried across blocks as the
//       TPU grid carries it; the partials keep it deterministic, with no
//       float atomics.
//
// Numerics: every product takes bf16 inputs (x, W, dy, n, dl), as the JAX
// package's do; sums of products and the row sums accumulate in f64 (bf16
// products are exact in f64) and round to f32 once; softmax, shrink and
// renorm are f32 IEEE operations written as intrinsics in the plain
// version's order (no FMA contraction). The plain versions in
// ops/memory_recon.py do the same, so the two agree to the last bit but for
// a rare order-dependent last f64 bit.
//
// Bound: operations. K6 is 2 and K7 5 products of R x M x C multiply-adds
// (R = 65,536 rows, M = 2000, C = 64 at hvpr.yaml batch 4), whose bound is
// that of bf16 tensor cores (989 TFLOP/s). These kernels run them as f64
// multiply-adds on the CUDA cores, far from that bound: exactness first,
// speed for a later change (tensor-core products with an exact split).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 64;
constexpr int kChunk = 64;              // memory rows per shared chunk
constexpr int kWStride = kMaxC + 1;     // padded f64 row of a chunk
constexpr int kFwdRows = 16;
constexpr int kBwdRows = 8;
constexpr int kMTile = 32;              // dW: memory rows per block
constexpr int kRChunk = 32;             // dW: rows per shared chunk
constexpr float kEps = 1e-12f;
constexpr float kDelta = 1e-12f;

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

// a = x W^T into L (rows x m), and b = y W^T into D when y is given
template <int ROWS>
__device__ void logits_pass(const __nv_bfloat16* __restrict__ w, const double* xs,
                            const double* ys, float* L, float* D, double* ws,
                            int m, int c) {
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
      if (ys != nullptr) {
        const double* yr = ys + rr * kMaxC;
        double acc2 = 0.0;
        for (int cc = 0; cc < c; ++cc) acc2 = fma(yr[cc], wr[cc], acc2);
        D[rr * m + m0 + mm] = (float)acc2;
      }
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
  logits_pass<kFwdRows>(w, xs, nullptr, L, nullptr, ws, m, c);

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

__global__ void __launch_bounds__(kThreads)
recon_bwd_rows_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      const __nv_bfloat16* __restrict__ dy, float* __restrict__ dx,
                      __nv_bfloat16* __restrict__ dl_out, __nv_bfloat16* __restrict__ n_out,
                      int r, int m, int c, float lam) {
  extern __shared__ double smem_d[];
  double* ws = smem_d;                                   // kChunk x kWStride
  double* xs = ws + kChunk * kWStride;                   // kBwdRows x kMaxC
  double* dys = xs + kBwdRows * kMaxC;                   // kBwdRows x kMaxC
  float* A = reinterpret_cast<float*>(dys + kBwdRows * kMaxC);  // kBwdRows x m
  float* D = A + kBwdRows * m;                                   // kBwdRows x m
  const int row0 = blockIdx.x * kBwdRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  load_rows(x, xs, row0, kBwdRows, r, c);
  load_rows(dy, dys, row0, kBwdRows, r, c);
  logits_pass<kBwdRows>(w, xs, dys, A, D, ws, m, c);     // A = logits, D = dn

  for (int rr = warp; rr < kBwdRows; rr += kWarps) {
    float* ar = A + rr * m;
    float* dr = D + rr * m;
    const bool live = row0 + rr < r;
    const size_t gbase = (size_t)(row0 + rr) * m;
    softmax_row(ar, m, lane);
    if (lam > 0.f) {
      double st = 0.0, dot = 0.0;
      for (int j = lane; j < m; j += 32) {
        const float s = shrink(ar[j], lam);
        st += (double)s;
        dot += (double)dr[j] * (double)s;
      }
      const float t_raw = (float)warp_sum(st);
      const float dotf = (float)warp_sum(dot);
      const float t = fmaxf(t_raw, kDelta);
      const float c1 = t_raw > kDelta ? __fdiv_rn(dotf, __fmul_rn(t, t)) : 0.f;
      for (int j = lane; j < m; j += 32) {
        const float a = ar[j];
        const float u = __fsub_rn(a, lam);
        if (live) n_out[gbase + j] = __float2bfloat16_rn(__fdiv_rn(shrink(a, lam), t));
        const float ds = __fsub_rn(__fdiv_rn(dr[j], t), c1);
        const float d = __fadd_rn(u, kEps);
        const float gp = u > 0.f
            ? __fsub_rn(__fdiv_rn(__fadd_rn(a, u), d),
                        __fdiv_rn(__fmul_rn(u, a), __fmul_rn(d, d)))
            : 0.f;
        dr[j] = __fmul_rn(ds, gp);                        // da
      }
    } else if (live) {
      for (int j = lane; j < m; j += 32) n_out[gbase + j] = __float2bfloat16_rn(ar[j]);
    }
    double s2 = 0.0;
    for (int j = lane; j < m; j += 32) s2 += (double)dr[j] * (double)ar[j];
    const float s2f = (float)warp_sum(s2);
    for (int j = lane; j < m; j += 32) {
      const __nv_bfloat16 dl = __float2bfloat16_rn(__fmul_rn(ar[j], __fsub_rn(dr[j], s2f)));
      dr[j] = __bfloat162float(dl);
      if (live) dl_out[gbase + j] = dl;
    }
  }
  product_pass<kBwdRows>(w, D, ws, dx, row0, r, m, c);
}

__global__ void __launch_bounds__(kThreads)
recon_dw_kernel(const __nv_bfloat16* __restrict__ dl, const __nv_bfloat16* __restrict__ n,
                const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                double* __restrict__ partial, int r, int m, int c, int rows_per_split) {
  __shared__ float dls[kRChunk][kMTile], ns[kRChunk][kMTile];
  __shared__ float xs[kRChunk][kMaxC], dys[kRChunk][kMaxC];
  constexpr int kOuts = kMTile * kMaxC / kThreads;       // 8
  constexpr int kGroups = kThreads / kMaxC;              // 4
  const int m0 = blockIdx.x * kMTile;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(r, r_begin + rows_per_split);
  const int cc = threadIdx.x % kMaxC, mg = threadIdx.x / kMaxC;
  double acc[kOuts];
  for (int k = 0; k < kOuts; ++k) acc[k] = 0.0;

  for (int rs = r_begin; rs < r_end; rs += kRChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kRChunk * kMTile; i += kThreads) {
      const int rr = i / kMTile, mm = i % kMTile;
      const bool ok = rs + rr < r_end && m0 + mm < m;
      const size_t g = (size_t)(rs + rr) * m + m0 + mm;
      dls[rr][mm] = ok ? to_f(dl[g]) : 0.f;
      ns[rr][mm] = ok ? to_f(n[g]) : 0.f;
    }
    for (int i = threadIdx.x; i < kRChunk * kMaxC; i += kThreads) {
      const int rr = i / kMaxC, c2 = i % kMaxC;
      const bool ok = rs + rr < r_end && c2 < c;
      const size_t g = (size_t)(rs + rr) * c + c2;
      xs[rr][c2] = ok ? to_f(x[g]) : 0.f;
      dys[rr][c2] = ok ? to_f(dy[g]) : 0.f;
    }
    __syncthreads();
    for (int rr = 0; rr < kRChunk; ++rr) {
      const double xv = (double)xs[rr][cc], dv = (double)dys[rr][cc];
      for (int k = 0; k < kOuts; ++k) {
        const int mm = mg + kGroups * k;
        acc[k] = fma((double)dls[rr][mm], xv, acc[k]);
        acc[k] = fma((double)ns[rr][mm], dv, acc[k]);
      }
    }
  }
  for (int k = 0; k < kOuts; ++k) {
    const int mm = m0 + mg + kGroups * k;
    if (mm < m && cc < c) partial[((size_t)split * m + mm) * c + cc] = acc[k];
  }
}

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

size_t bwd_smem(int m) {
  return sizeof(double) * (kChunk * kWStride + 2 * kBwdRows * kMaxC)
         + sizeof(float) * 2 * kBwdRows * m;
}

}  // namespace

extern "C" int hvpr_memory_recon_fwd(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                     float* y, int r, int m, int c, float lam,
                                     void* stream) {
  const size_t smem = fwd_smem(m);
  cudaError_t err = cudaFuncSetAttribute(
      recon_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (r + kFwdRows - 1) / kFwdRows;
  recon_fwd_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(x, w, y, r, m, c, lam);
  return (int)cudaGetLastError();
}

extern "C" int hvpr_memory_recon_bwd(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                     const __nv_bfloat16* dy, float* dx,
                                     __nv_bfloat16* dl, __nv_bfloat16* n,
                                     double* partial, float* dw, int r, int m, int c,
                                     float lam, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = bwd_smem(m);
  cudaError_t err = cudaFuncSetAttribute(
      recon_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (r + kBwdRows - 1) / kBwdRows;
  recon_bwd_rows_kernel<<<blocks, kThreads, smem, s>>>(x, w, dy, dx, dl, n, r, m, c, lam);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int rows_per_split = (r + splits - 1) / splits;
  dim3 grid((m + kMTile - 1) / kMTile, splits);
  recon_dw_kernel<<<grid, kThreads, 0, s>>>(dl, n, x, dy, partial, r, m, c, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int count = m * c;
  recon_dw_reduce_kernel<<<(count + 255) / 256, 256, 0, s>>>(partial, dw, count, splits);
  return (int)cudaGetLastError();
}
