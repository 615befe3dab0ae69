// Top-k-masked attention for training: the bucket threshold (kernel K8), the
// masked softmax aggregation (K9) and its backward (K10), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of hvpr_tpu/ops/topk_attend.py:
//   K8  hvpr_bucket_threshold:   :179 `_bmax_kernel` and :204 `_thresh_kernel`
//   K9  hvpr_masked_attend_fwd:  :376 `_attend_fwd_kernel`
//   K10 hvpr_masked_attend_bwd:  :427 `_bwd_kernel`
// with the semantics of the JAX package's XLA twin (bucket_threshold's XLA
// branch and _attend_emulation), spelled out in ops/topk_attend.py. Per
// pillar row of scan b, s[n] = bf16(pillar) . bf16(sel[b, n]) + neg[b, n]
// over the scan's N points; buckets are n mod 128.
//
// Numerics: every dot product of bf16 values is exact in f64 and is rounded
// to f32 once (then neg is added in f32); den sums f32 terms in f64; out and
// dval sum bf16 x bf16 and bf16 x f32 products in f64 and round once. The
// f32 softmax steps are the plain version's IEEE operations in its order.
// So the kernels and the plain versions select the same points and agree to
// the bit but for the order-dependent last bit of an f64 sum.
//
// What bounds them: operations. Each kernel makes the dense (rows, N) score
// product of the rows it processes, 2*R*N*C flops (8.0e10 at hvpr.yaml batch
// 4: R = 38,047 valid rows, N = 16,384, C = 64), against ~25 MB of inputs;
// the softmax and value products touch only the selected points (~k a
// row). These kernels run the products as f64 multiply-adds on the CUDA
// cores (for the exact sums above), far from the bf16 tensor-core bound;
// FP64 tensor cores (mma.sync m8n8k4) or bf16 wgmma are later work.
//
// Design. A tile is 32 pillar rows of one scan, held in shared memory as
// f64, channel-major. The scan's table streams through shared memory in
// 128-point chunks (f64, channel-major, 64 KB), so a chunk holds exactly
// one point of each bucket. Warp w owns rows 4w..4w+3 and lane t columns
// t, t+32, t+64, t+96 of a chunk: 16 f64 sums a thread, the pillar values
// read as broadcasts and the chunk's columns conflict-free.
//   K8  keeps each thread's 16 bucket maxima in registers over the chunks;
//       a warp then finds each row's k-th largest of 128 maxima by counting
//       (greater / greater-or-equal), as K2 does.
//   K9  appends each row's selected points (index, score) to a list in
//       shared memory during the one dense sweep, in index order (ballots).
//       A row with at most 128 selected points then finishes from its list:
//       logits (split: one dot a point), max, exp, f64 den, bf16 weights, and
//       the output with lanes over channels. A row that selects more (a tie
//       over many points) is redone by its warp in three passes over all N
//       points, so any count from 0 to N is right.
//   K10 has no atomics: a block owns 128 points of one scan and walks every
//       tile of the scan's valid rows in order, recomputing the scores, the
//       selection and the bf16 weights from the forward's saved max and den;
//       a thread owns 32 channels of one point and adds w * dout in row
//       order into f64 registers, so dval is the same bits on every run.
// Rows outside the row mask are skipped (their outputs are 0), and a tile
// without a valid row costs one check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;                    // pillar rows per tile
constexpr int kChunk = 128;                  // points per chunk == buckets
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;     // 4
constexpr int kColsPerLane = kChunk / 32;        // 4
constexpr int kMaxC = 64;
constexpr int kCap = 128;                    // K9: selected points a row's list holds
constexpr int kHalfC = kMaxC / 2;            // K10: channels a thread owns
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRowsPerWarp == 4 && kColsPerLane == 4, "tile mapping");
static_assert(kThreads == 2 * kChunk, "K10: two threads (channel halves) a point");

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ bool row_valid(const bool* __restrict__ row_mask, int b,
                                          int v, int V) {
  return v < V && row_mask[(size_t)b * V + v];
}

// true in every thread when a row of the tile [v0, v0 + kRows) is valid;
// also a block barrier
__device__ __forceinline__ bool tile_has_valid(const bool* __restrict__ row_mask, int b,
                                               int v0, int V) {
  const int t = threadIdx.x;
  return __syncthreads_or(t < kRows && row_valid(row_mask, b, v0 + t, V)) != 0;
}

// pillar rows [v0, v0 + kRows) of scan b as f64, channel-major:
// ps[c * kRows + r] (zeros past V and past C)
__device__ void load_pillars(const __nv_bfloat16* __restrict__ pill, double* ps, int b,
                             int v0, int V, int C) {
  for (int i = threadIdx.x; i < kRows * kMaxC; i += kThreads) {
    const int r = i % kRows, c = i / kRows;
    double x = 0.0;
    if (v0 + r < V && c < C) x = (double)__bfloat162float(pill[((size_t)b * V + v0 + r) * C + c]);
    ps[c * kRows + r] = x;
  }
}

// points [n0, n0 + kChunk) of a scan's (N, C) bf16 table as f64,
// channel-major: ts[c * kChunk + j] (zeros past N). C % 8 == 0; 16-byte
// loads, all in flight before the first store; a warp writes 32 consecutive
// points of one channel (no bank conflict).
__device__ void load_chunk(const __nv_bfloat16* __restrict__ tab, double* ts, int n0,
                           int N, int C) {
  constexpr int kMaxVec = kChunk * kMaxC / 8 / kThreads;   // 4
  const int vpr = C / 8;                                   // vectors per point
  uint4 v[kMaxVec];
#pragma unroll
  for (int u = 0; u < kMaxVec; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int j = i % kChunk, q = i / kChunk;
    v[u] = make_uint4(0u, 0u, 0u, 0u);
    if (q < vpr && n0 + j < N)
      v[u] = *reinterpret_cast<const uint4*>(tab + (size_t)(n0 + j) * C + q * 8);
  }
#pragma unroll
  for (int u = 0; u < kMaxVec; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int j = i % kChunk, q = i / kChunk;
    if (q < vpr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[u]);
#pragma unroll
      for (int t = 0; t < 8; ++t) ts[(q * 8 + t) * kChunk + j] = (double)__bfloat162float(e[t]);
    }
  }
}

// acc[i][j] = sum over c of ps[c][4 warp + i] * ts[c][lane + 32 j], in f64
__device__ __forceinline__ void tile_dot(const double* ps, const double* ts, int C,
                                         double (&acc)[kRowsPerWarp][kColsPerLane]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) acc[i][j] = 0.0;
  const double* pr = ps + warp * kRowsPerWarp;
  const double* tr = ts + lane;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const double2 p01 = *reinterpret_cast<const double2*>(pr + c * kRows);
    const double2 p23 = *reinterpret_cast<const double2*>(pr + c * kRows + 2);
    const double p[kRowsPerWarp] = {p01.x, p01.y, p23.x, p23.y};
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const double t = tr[c * kChunk + 32 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) acc[i][j] = fma(p[i], t, acc[i][j]);
    }
  }
}

// bf16(pillar row r of the tile) . x for one bf16 row x of C values
__device__ __forceinline__ float dot_row(const double* ps, int r,
                                         const __nv_bfloat16* __restrict__ x, int C) {
  double acc = 0.0;
  for (int c = 0; c < C; c += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      acc = fma(ps[(c + u) * kRows + r], (double)__bfloat162float(e[u]), acc);
  }
  return __double2float_rn(acc);
}

// k-th largest of a row's 128 bucket maxima, ties counted (one warp)
__device__ float kth_largest(const float* bm, int k, int lane) {
  float v[4];
  int gt[4], ge[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = bm[lane * 4 + q];
    gt[q] = 0;
    ge[q] = 0;
  }
  for (int j = 0; j < kChunk; ++j) {
    const float u = bm[j];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      gt[q] += u > v[q];
      ge[q] += u >= v[q];
    }
  }
  float th = -CUDART_INF_F;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (gt[q] < k && k <= ge[q]) th = fmaxf(th, v[q]);
  return warp_max(th);
}

// ----------------------------------------------------------------- K8

__global__ void __launch_bounds__(kThreads, 2)
bucket_threshold_kernel(const __nv_bfloat16* __restrict__ pill,
                        const __nv_bfloat16* __restrict__ tab,
                        const float* __restrict__ neg, const bool* __restrict__ row_mask,
                        float* __restrict__ th_out, int V, int N, int C, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ps = reinterpret_cast<double*>(smem);            // kMaxC x kRows
  double* ts = ps + kMaxC * kRows;                          // kMaxC x kChunk
  float* bm = reinterpret_cast<float*>(ts);                 // kRows x kChunk, at the end
  const int b = blockIdx.y, v0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (!tile_has_valid(row_mask, b, v0, V)) {
    const int t = threadIdx.x;
    if (t < kRows && v0 + t < V) th_out[(size_t)b * V + v0 + t] = 0.f;
    return;
  }
  load_pillars(pill, ps, b, v0, V, C);
  const __nv_bfloat16* tb = tab + (size_t)b * N * C;
  const float* nb = neg + (size_t)b * N;

  // bucket maxima of rows 4 warp + i, buckets lane + 32 j
  float bmax[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) bmax[i][j] = -CUDART_INF_F;

  const int n_chunks = (N + kChunk - 1) / kChunk;
  for (int ch = 0; ch < n_chunks; ++ch) {
    __syncthreads();
    load_chunk(tb, ts, ch * kChunk, N, C);
    __syncthreads();
    double acc[kRowsPerWarp][kColsPerLane];
    tile_dot(ps, ts, C, acc);
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int n = ch * kChunk + lane + 32 * j;
      const float ng = n < N ? nb[n] : 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        // padded points score exactly -1e30, as the twin's zero rows + neg
        const float s = n < N ? __fadd_rn(__double2float_rn(acc[i][j]), ng) : kNeg;
        bmax[i][j] = fmaxf(bmax[i][j], s);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j)
      bm[(warp * kRowsPerWarp + i) * kChunk + lane + 32 * j] = bmax[i][j];
  __syncthreads();
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const float th = kth_largest(bm + r * kChunk, k, lane);
    const int v = v0 + r;
    if (lane == 0 && v < V) th_out[(size_t)b * V + v] = row_valid(row_mask, b, v, V) ? th : 0.f;
  }
}

// ----------------------------------------------------------------- K9

// One row from its list of n selected points (n <= kCap): lidx holds their
// indices in ascending order, lval their scores; lval is overwritten.
__device__ void attend_from_list(const double* ps, int r, const int* lidx, float* lval,
                                 int count, const __nv_bfloat16* __restrict__ valb,
                                 bool shared, int C, int lane, float* __restrict__ out_row,
                                 float& mx, float& den) {
  if (!shared)
    for (int e = lane; e < count; e += 32) lval[e] = dot_row(ps, r, valb + (size_t)lidx[e] * C, C);
  __syncwarp();
  float m = kNeg;
  for (int e = lane; e < count; e += 32) m = fmaxf(m, lval[e]);
  m = warp_max(m);
  double sd = 0.0;
  for (int e = lane; e < count; e += 32) {
    const float ex = expf(__fsub_rn(lval[e], m));
    lval[e] = ex;
    sd += (double)ex;
  }
  const float d = __double2float_rn(warp_sum(sd));
  for (int e = lane; e < count; e += 32)
    lval[e] = d > 0.f ? bf16_round(__fdiv_rn(lval[e], fmaxf(d, 1e-30f))) : 0.f;
  __syncwarp();
  // out = sum of w * val over the list in index order; lane owns channels
  // lane and lane + 32
  double a0 = 0.0, a1 = 0.0;
  for (int e = 0; e < count; ++e) {
    const double w = (double)lval[e];
    const __nv_bfloat16* vr = valb + (size_t)lidx[e] * C;
    if (lane < C) a0 = fma(w, (double)__bfloat162float(vr[lane]), a0);
    if (lane + 32 < C) a1 = fma(w, (double)__bfloat162float(vr[lane + 32]), a1);
  }
  if (lane < C) out_row[lane] = __double2float_rn(a0);
  if (lane + 32 < C) out_row[lane + 32] = __double2float_rn(a1);
  mx = m;
  den = d;
}

// One row with more than kCap selected points, by one warp in three passes
// over all N points: row max of the logits, den, then the output.
__device__ __noinline__ void attend_dense(const double* ps, int r, const __nv_bfloat16* __restrict__ selb,
                             const __nv_bfloat16* __restrict__ valb,
                             const float* __restrict__ nb, float thr, int N, int C,
                             bool shared, int lane, float* __restrict__ out_row, float& mx,
                             float& den) {
  float m = kNeg;
  for (int n = lane; n < N; n += 32) {
    if (nb[n] != 0.f) continue;
    const float s = __fadd_rn(dot_row(ps, r, selb + (size_t)n * C, C), nb[n]);
    if (s >= thr) m = fmaxf(m, shared ? s : dot_row(ps, r, valb + (size_t)n * C, C));
  }
  m = warp_max(m);
  double sd = 0.0;
  for (int n = lane; n < N; n += 32) {
    if (nb[n] != 0.f) continue;
    const float s = __fadd_rn(dot_row(ps, r, selb + (size_t)n * C, C), nb[n]);
    if (s >= thr) {
      const float l = shared ? s : dot_row(ps, r, valb + (size_t)n * C, C);
      sd += (double)expf(__fsub_rn(l, m));
    }
  }
  const float d = __double2float_rn(warp_sum(sd));
  double a0 = 0.0, a1 = 0.0;
  for (int n0 = 0; n0 < N; n0 += 32) {
    const int n = n0 + lane;
    float w = 0.f;
    if (n < N && nb[n] == 0.f) {
      const float s = __fadd_rn(dot_row(ps, r, selb + (size_t)n * C, C), nb[n]);
      if (s >= thr) {
        const float l = shared ? s : dot_row(ps, r, valb + (size_t)n * C, C);
        w = bf16_round(__fdiv_rn(expf(__fsub_rn(l, m)), fmaxf(d, 1e-30f)));
      }
    }
    unsigned nz = __ballot_sync(kFull, w != 0.f);
    while (nz) {
      const int q = __ffs(nz) - 1;
      nz &= nz - 1;
      const double wq = (double)__shfl_sync(kFull, w, q);
      const __nv_bfloat16* vr = valb + (size_t)(n0 + q) * C;
      if (lane < C) a0 = fma(wq, (double)__bfloat162float(vr[lane]), a0);
      if (lane + 32 < C) a1 = fma(wq, (double)__bfloat162float(vr[lane + 32]), a1);
    }
  }
  if (lane < C) out_row[lane] = __double2float_rn(a0);
  if (lane + 32 < C) out_row[lane + 32] = __double2float_rn(a1);
  mx = m;
  den = d;
}

__global__ void __launch_bounds__(kThreads, 2)
masked_attend_fwd_kernel(const __nv_bfloat16* __restrict__ pill,
                         const __nv_bfloat16* __restrict__ sel,
                         const __nv_bfloat16* __restrict__ val,
                         const float* __restrict__ neg, const float* __restrict__ th,
                         const bool* __restrict__ row_mask, float* __restrict__ out,
                         float* __restrict__ mx_out, float* __restrict__ den_out,
                         int* __restrict__ cnt_out, int V, int N, int C, int shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ps = reinterpret_cast<double*>(smem);            // kMaxC x kRows
  double* ts = ps + kMaxC * kRows;                          // kMaxC x kChunk
  int* lidx = reinterpret_cast<int*>(ts + kMaxC * kChunk);  // kRows x kCap
  float* lval = reinterpret_cast<float*>(lidx + kRows * kCap);   // kRows x kCap
  const int b = blockIdx.y, v0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (size_t)b * V + v0;

  if (!tile_has_valid(row_mask, b, v0, V)) {
    for (int i = threadIdx.x; i < kRows * C; i += kThreads)
      if (v0 + i / C < V) out[row0 * C + i] = 0.f;
    const int t = threadIdx.x;
    if (t < kRows && v0 + t < V) {
      mx_out[row0 + t] = 0.f;
      den_out[row0 + t] = 0.f;
      cnt_out[row0 + t] = 0;
    }
    return;
  }
  load_pillars(pill, ps, b, v0, V, C);
  const __nv_bfloat16* selb = sel + (size_t)b * N * C;
  const __nv_bfloat16* valb = val + (size_t)b * N * C;
  const float* nb = neg + (size_t)b * N;

  // a row outside the mask selects nothing (its threshold is +inf)
  float thr[kRowsPerWarp];
  bool live[kRowsPerWarp];
  int cnt[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int v = v0 + warp * kRowsPerWarp + i;
    live[i] = row_valid(row_mask, b, v, V);
    thr[i] = live[i] ? th[(size_t)b * V + v] : CUDART_INF_F;
    cnt[i] = 0;
  }
  const unsigned below = (1u << lane) - 1u;

  // the dense sweep: scores, selection, the rows' lists in index order
  const int n_chunks = (N + kChunk - 1) / kChunk;
  for (int ch = 0; ch < n_chunks; ++ch) {
    __syncthreads();
    load_chunk(selb, ts, ch * kChunk, N, C);
    __syncthreads();
    double acc[kRowsPerWarp][kColsPerLane];
    tile_dot(ps, ts, C, acc);
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int n = ch * kChunk + lane + 32 * j;
      const float ng = n < N ? nb[n] : kNeg;
      const bool ok = n < N && ng == 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float s = __fadd_rn(__double2float_rn(acc[i][j]), ng);
        const bool pick = ok && s >= thr[i];
        const unsigned ball = __ballot_sync(kFull, pick);
        if (pick) {
          const int pos = cnt[i] + __popc(ball & below);
          if (pos < kCap) {
            const int r = warp * kRowsPerWarp + i;
            lidx[r * kCap + pos] = n;
            lval[r * kCap + pos] = s;
          }
        }
        cnt[i] += __popc(ball);
      }
    }
  }
  __syncwarp();

  // each warp finishes its own rows
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int v = v0 + r;
    if (v >= V) continue;
    float* out_row = out + (row0 + r) * C;
    float m = 0.f, d = 0.f;
    if (!live[i]) {
      if (lane < C) out_row[lane] = 0.f;
      if (lane + 32 < C) out_row[lane + 32] = 0.f;
    } else if (cnt[i] <= kCap) {
      attend_from_list(ps, r, lidx + r * kCap, lval + r * kCap, cnt[i], valb, shared != 0,
                       C, lane, out_row, m, d);
    } else {
      attend_dense(ps, r, selb, valb, nb, thr[i], N, C, shared != 0, lane, out_row, m, d);
    }
    if (lane == 0) {
      mx_out[row0 + r] = m;
      den_out[row0 + r] = d;
      cnt_out[row0 + r] = live[i] ? cnt[i] : 0;
    }
  }
}

// ----------------------------------------------------------------- K10

__global__ void __launch_bounds__(kThreads, 2)
masked_attend_bwd_kernel(const __nv_bfloat16* __restrict__ pill,
                         const __nv_bfloat16* __restrict__ sel,
                         const __nv_bfloat16* __restrict__ val,
                         const float* __restrict__ neg, const float* __restrict__ th,
                         const float* __restrict__ mx, const float* __restrict__ den,
                         const float* __restrict__ dout, const bool* __restrict__ row_mask,
                         float* __restrict__ dval, int V, int N, int C, int shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ts = reinterpret_cast<double*>(smem);            // kMaxC x kChunk, fixed
  double* ps = ts + kMaxC * kChunk;                         // kMaxC x kRows
  float* W = reinterpret_cast<float*>(ps + kMaxC * kRows);  // kRows x kChunk
  float* D = W + kRows * kChunk;                            // kRows x kMaxC
  float* rth = D + kRows * kMaxC;                           // kRows
  float* rmx = rth + kRows;                                 // kRows
  float* rden = rmx + kRows;                                // kRows
  const int b = blockIdx.y, n0 = blockIdx.x * kChunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* selb = sel + (size_t)b * N * C;
  const __nv_bfloat16* valb = val + (size_t)b * N * C;
  const float* nb = neg + (size_t)b * N;

  load_chunk(selb, ts, n0, N, C);
  // this thread's point and channel half for the accumulation
  const int jo = threadIdx.x % kChunk, half = threadIdx.x / kChunk;
  double acc[kHalfC];
#pragma unroll
  for (int c = 0; c < kHalfC; ++c) acc[c] = 0.0;

  for (int v0 = 0; v0 < V; v0 += kRows) {
    // (a barrier too: the last tile's reads of ps, W and D are done)
    if (!tile_has_valid(row_mask, b, v0, V)) continue;
    load_pillars(pill, ps, b, v0, V, C);
    for (int i = threadIdx.x; i < kRows * kMaxC; i += kThreads) {
      const int r = i / kMaxC, c = i % kMaxC;
      D[i] = (v0 + r < V && c < C) ? dout[((size_t)b * V + v0 + r) * C + c] : 0.f;
    }
    if (threadIdx.x < kRows) {
      const int v = v0 + threadIdx.x;
      const bool live = row_valid(row_mask, b, v, V);
      rth[threadIdx.x] = live ? th[(size_t)b * V + v] : CUDART_INF_F;
      rmx[threadIdx.x] = live ? mx[(size_t)b * V + v] : 0.f;
      rden[threadIdx.x] = live ? den[(size_t)b * V + v] : 0.f;
    }
    __syncthreads();
    double s64[kRowsPerWarp][kColsPerLane];
    tile_dot(ps, ts, C, s64);
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int n = n0 + lane + 32 * j;
      const float ng = n < N ? nb[n] : kNeg;
      const bool ok = n < N && ng == 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp * kRowsPerWarp + i;
        const float s = __fadd_rn(__double2float_rn(s64[i][j]), ng);
        float w = 0.f;
        if (ok && s >= rth[r]) {
          const float l = shared ? s : dot_row(ps, r, valb + (size_t)n * C, C);
          const float e = expf(__fsub_rn(l, rmx[r]));
          const float d = rden[r];
          w = d > 0.f ? bf16_round(__fdiv_rn(e, fmaxf(d, 1e-30f))) : 0.f;
        }
        W[r * kChunk + lane + 32 * j] = w;
      }
    }
    __syncthreads();
    for (int r = 0; r < kRows; ++r) {
      const float w = W[r * kChunk + jo];
      if (w != 0.f) {
        const float* dr = D + r * kMaxC + half * kHalfC;
#pragma unroll
        for (int c = 0; c < kHalfC; ++c) acc[c] = fma((double)w, (double)dr[c], acc[c]);
      }
    }
  }
  const int n = n0 + jo;
  if (n < N) {
    float* dst = dval + ((size_t)b * N + n) * C + half * kHalfC;
#pragma unroll
    for (int c = 0; c < kHalfC; ++c)
      if (half * kHalfC + c < C) dst[c] = bf16_round(__double2float_rn(acc[c]));
  }
}

constexpr size_t kThreshSmem = sizeof(double) * (kMaxC * kRows + kMaxC * kChunk);
constexpr size_t kFwdSmem = kThreshSmem + (sizeof(int) + sizeof(float)) * kRows * kCap;
constexpr size_t kBwdSmem = kThreshSmem + sizeof(float) * (kRows * kChunk + kRows * kMaxC + 3 * kRows);

}  // namespace

// pillars (B, V, C), tab (B, N, C) bf16; neg (B, N) f32; row_mask (B, V)
// bool; th (B, V) f32 out (0 outside the mask). C % 8 == 0, C <= 64,
// 1 <= k <= 128. Returns cudaGetLastError() after the launch.
extern "C" int hvpr_bucket_threshold(const void* pill, const void* tab, const float* neg,
                                     const void* row_mask, float* th, int B, int V, int N,
                                     int C, int k, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(bucket_threshold_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kThreshSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((V + kRows - 1) / kRows, B);
  bucket_threshold_kernel<<<grid, kThreads, kThreshSmem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(pill), static_cast<const __nv_bfloat16*>(tab), neg,
      static_cast<const bool*>(row_mask), th, V, N, C, k);
  return (int)cudaGetLastError();
}

// pillars (B, V, C), sel and val (B, N, C) bf16 (one pointer when shared);
// neg (B, N), th (B, V) f32; row_mask (B, V) bool; out (B, V, C),
// mx, den (B, V) f32 and cnt (B, V) int32 out (0 outside the mask).
extern "C" int hvpr_masked_attend_fwd(const void* pill, const void* sel, const void* val,
                                      const float* neg, const float* th, const void* row_mask,
                                      float* out, float* mx, float* den, int* cnt, int B,
                                      int V, int N, int C, int shared, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(masked_attend_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((V + kRows - 1) / kRows, B);
  masked_attend_fwd_kernel<<<grid, kThreads, kFwdSmem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(pill), static_cast<const __nv_bfloat16*>(sel),
      static_cast<const __nv_bfloat16*>(val), neg, th, static_cast<const bool*>(row_mask),
      out, mx, den, cnt, V, N, C, shared);
  return (int)cudaGetLastError();
}

// the forward's inputs and its mx, den; dout (B, V, C) f32; dval (B, N, C)
// f32 out, each value bf16-exact.
extern "C" int hvpr_masked_attend_bwd(const void* pill, const void* sel, const void* val,
                                      const float* neg, const float* th, const float* mx,
                                      const float* den, const float* dout,
                                      const void* row_mask, float* dval, int B, int V, int N,
                                      int C, int shared, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(masked_attend_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kBwdSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kChunk - 1) / kChunk, B);
  masked_attend_bwd_kernel<<<grid, kThreads, kBwdSmem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(pill), static_cast<const __nv_bfloat16*>(sel),
      static_cast<const __nv_bfloat16*>(val), neg, th, mx, den, dout,
      static_cast<const bool*>(row_mask), dval, V, N, C, shared);
  return (int)cudaGetLastError();
}
