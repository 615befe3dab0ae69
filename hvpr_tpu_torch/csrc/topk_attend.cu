// Top-k-masked attention for training: the bucket threshold (kernel K8), the
// masked softmax aggregation (K9) and its backward (K10), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of hvpr_tpu/ops/topk_attend.py:
//   K8  hvpr_bucket_threshold:   :179 `_bmax_kernel` and :204 `_thresh_kernel`
//   K9  hvpr_masked_attend_fwd and hvpr_masked_attend_pairs: :376 `_attend_fwd_kernel`
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
// What bounds them. K8 and K9 make the dense (rows, N) score product of
// the rows they process, 2*R*N*C flops (8.0e10 at hvpr.yaml batch 4: R =
// 38,047 valid rows, N = 16,384, C = 64), against ~25 MB of inputs: bound
// by operations. K8 and K9 run them on the FP64 tensor cores (mma.sync
// m16n8k16 .f64, DMMA, 67 TFLOP/s: 1.19 ms for that product, against 0.08
// ms on bf16 tensor cores), for the exact sums above. (The m8n8k4 shape
// that K2, K6 and K7 use took 3.4 ms for K9's sweep, m16n8k4 2.5 and
// m16n8k8 or m16n8k16 2.4 on an H100, measured when K8 moved onto K9's
// sweep: PERF.md, K8 and K9.) K10 touches only the selected pairs
// (~825k a call at hvpr.yaml), 2*C flops each, against the valid rows of
// dout (9.7 MB), the pairs (~5 MB) and dval (16.8 MB): bound by bytes,
// ~0.01 ms a call at 3.35 TB/s.
//
// Design.
//   K8 and K9's dense sweep share one sweep body (dmma_sweep): a tile of 16
//       pillar rows of one scan, the scan's table streamed through shared
//       memory in 128-point chunks, the scores on DMMA, and a callback given
//       each chunk's scores. A chunk holds exactly one point of each bucket.
//   K8  keeps, in each lane's registers, the running bucket maxima of the
//       scores it holds: its 2 rows x 8 points of a chunk are the same 8
//       buckets in every chunk, so no barrier is needed beyond the double
//       buffer's. After the sweep the tile's 16 x 128 maxima go to shared
//       memory, and a warp finds each row's k-th largest of 128 maxima by
//       counting (greater / greater-or-equal), as K2 does.
//   K9  two kernels. The dense sweep (masked_attend_fwd_kernel): a tile of
//       16 rows, 4 warps, 4 blocks an SM, the table streamed as bf16 by
//       cp.async, the scores on DMMA (the sweep body K8 shares). The
//       table (2 MB a scan) is read from L2 once a tile: 2,378 tiles of 16
//       rows read 4.9 GB a call at hvpr.yaml batch 4, 600 of 64 rows 1.2
//       GB. Yet on the same inputs, with the earlier m8n8k4 sweep,
//       64-row tiles (one block an SM, 16 warps) took 3.93 ms, 32-row 3.62
//       and 16-row 3.41 on an H100 (PERF.md, K9, measured when K9's
//       sweep moved onto DMMA): four blocks an
//       SM overlap one block's barriers with another's DMMA, and L2
//       serves the 4.9 GB at ~1.4 TB/s, well inside its rate. K8's
//       threshold is known before the sweep, so no score is kept: each row
//       appends its selected points (index, score) to a list in shared
//       memory in index order (ballot masks, then the tile's 4 column warps
//       in point order). A row with at most
//       128 selected points finishes from its list: logits (split: one dot
//       a point), max, exp, f64 den, bf16 weights, and the output with
//       lanes over channels. It also writes the list out, the "pairs": the
//       row's kCap slots of point index (int32) and the bf16 weight it used
//       for out, index -1 and weight 0 past its count. A row that selects
//       more (a tie over many points) is redone by its warp in three passes
//       over all N points, so any count from 0 to N is right; its slots
//       are all -1 (an overflow row). The pair pass
//       (masked_attend_pairs_kernel) serves a call handed an earlier call's
//       selection (the fused step's split call reads the shared call's
//       count and pairs): no sweep, each listed row's logits over its
//       listed points only, overflow rows by the three passes.
//   K10 is a deterministic transpose-reduce of the pairs, with no float
//       atomics, in steps on the stream: (a) count the pairs of each point
//       (integer atomics); (b) an exclusive scan of the counts into segment
//       offsets, in tiles of 4096 (tile sums, then each tile after the ones
//       before it), which also lists the long points (more than kPiece =
//       256 rows); (c) place each pair's key (row * kCap + slot) into its
//       point's segment (integer atomics: in no fixed order); (d) sort each
//       short segment by key, a thread a pair counting the smaller keys of
//       its segment, and (d') each long one by a block, a counting sort by
//       row through a byte map of the scan's rows in shared memory (a point
//       is listed once a row at most); (e) list each scan's overflow rows in
//       ascending order; (f) a warp a short point sums bf16(w) * dout[v]
//       over its rows in ascending order into f64 registers (lanes over
//       channels, 8 rows' loads in flight), merging in the overflow rows,
//       whose scores and weights it recomputes at that point from the
//       forward's saved max and den; (f') a block a long point, its rows
//       cut into pieces of kPiece, each summed so by a warp, the warps'
//       sums added in warp order. So dval is the same bits on every run.
//       (Random weights make hub points: at hvpr.yaml batch 4 one point is
//       listed by 8,760 rows, against 12.6 on average.)
// Rows outside the row mask are skipped (their outputs are 0), and a tile
// without a valid row costs one check.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>
#include <stdint.h>

#include "dmma.cuh"

namespace {

constexpr int kRows = 32;                    // K9's pair pass: pillar rows per tile
constexpr int kChunk = 128;                  // points per chunk == buckets
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;     // 4
constexpr int kMaxC = 64;
constexpr int kCap = 128;                    // K9: selected points a row's list holds
constexpr int kScanThreads = 1024;           // K10 (b), (e): one block
constexpr int kScanTile = 4 * kScanThreads;  // K10 (b): counts a block scans
constexpr int kPiece = 256;                  // K10: rows of a short point, of a piece
constexpr int kLongThreads = 1024;           // K10 (d'), (f'): a block a long point
constexpr int kLongWarps = kLongThreads / 32;
constexpr int kSlotWindow = 32768;           // K10 (d'): rows its shared slot map covers
constexpr int kLongBlocks = 132;             // K10 (d'), (f'): blocks over the long points
constexpr int kAhead = 8;                    // K10 (f): rows whose dout loads are in flight
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

using hvpr::bf16_round;

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

// true in every thread when a row of the tile [v0, v0 + ROWS) is valid;
// also a block barrier (the block has at least ROWS threads)
template <int ROWS = kRows>
__device__ __forceinline__ bool tile_has_valid(const bool* __restrict__ row_mask, int b,
                                               int v0, int V) {
  const int t = threadIdx.x;
  return __syncthreads_or(t < ROWS && row_valid(row_mask, b, v0 + t, V)) != 0;
}

// pillar rows [v0, v0 + ROWS) of scan b as f64, channel-major:
// ps[c * ROWS + r] (zeros past V and past C), by THREADS threads
template <int ROWS = kRows, int THREADS = kThreads>
__device__ void load_pillars(const __nv_bfloat16* __restrict__ pill, double* ps, int b,
                             int v0, int V, int C) {
  for (int i = threadIdx.x; i < ROWS * kMaxC; i += THREADS) {
    const int r = i % ROWS, c = i / ROWS;
    double x = 0.0;
    if (v0 + r < V && c < C) x = (double)__bfloat162float(pill[((size_t)b * V + v0 + r) * C + c]);
    ps[c * ROWS + r] = x;
  }
}

// bf16(pillar row r of the tile) . x for one bf16 row x of C values; the
// tile is channel-major with `stride` rows
__device__ __forceinline__ float dot_row(const double* ps, int stride, int r,
                                         const __nv_bfloat16* __restrict__ x, int C) {
  double acc = 0.0;
  for (int c = 0; c < C; c += 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(x + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      acc = fma(ps[(c + u) * stride + r], (double)__bfloat162float(e[u]), acc);
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

// ----------------------------------------------------------------- K9

// One row from its list of n selected points (n <= kCap): lidx holds their
// indices in ascending order, lval their logits when have_logits (else they
// are computed here, bf16(pillar) . bf16(val)); lval is overwritten with the
// row's bf16 weights.
__device__ void attend_from_list(const double* ps, int ps_stride, int r, const int* lidx,
                                 float* lval, int count,
                                 const __nv_bfloat16* __restrict__ valb, bool have_logits,
                                 int C, int lane, float* __restrict__ out_row, float& mx,
                                 float& den) {
  if (!have_logits)
    for (int e = lane; e < count; e += 32)
      lval[e] = dot_row(ps, ps_stride, r, valb + (size_t)lidx[e] * C, C);
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
__device__ __noinline__ void attend_dense(const double* ps, int ps_stride, int r,
                                          const __nv_bfloat16* __restrict__ selb,
                                          const __nv_bfloat16* __restrict__ valb,
                                          const float* __restrict__ nb, float thr, int N,
                                          int C, bool shared, int lane,
                                          float* __restrict__ out_row, float& mx,
                                          float& den) {
  float m = kNeg;
  for (int n = lane; n < N; n += 32) {
    if (nb[n] != 0.f) continue;
    const float s = __fadd_rn(dot_row(ps, ps_stride, r, selb + (size_t)n * C, C), nb[n]);
    if (s >= thr)
      m = fmaxf(m, shared ? s : dot_row(ps, ps_stride, r, valb + (size_t)n * C, C));
  }
  m = warp_max(m);
  double sd = 0.0;
  for (int n = lane; n < N; n += 32) {
    if (nb[n] != 0.f) continue;
    const float s = __fadd_rn(dot_row(ps, ps_stride, r, selb + (size_t)n * C, C), nb[n]);
    if (s >= thr) {
      const float l = shared ? s : dot_row(ps, ps_stride, r, valb + (size_t)n * C, C);
      sd += (double)expf(__fsub_rn(l, m));
    }
  }
  const float d = __double2float_rn(warp_sum(sd));
  double a0 = 0.0, a1 = 0.0;
  for (int n0 = 0; n0 < N; n0 += 32) {
    const int n = n0 + lane;
    float w = 0.f;
    if (n < N && nb[n] == 0.f) {
      const float s = __fadd_rn(dot_row(ps, ps_stride, r, selb + (size_t)n * C, C), nb[n]);
      if (s >= thr) {
        const float l = shared ? s : dot_row(ps, ps_stride, r, valb + (size_t)n * C, C);
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

// What a row's finish needs besides its list: the scan's tables, the
// outputs, and the row's place in them.
struct AttendOut {
  const __nv_bfloat16* selb;     // the scan's (N, C) tables and neg
  const __nv_bfloat16* valb;
  const float* nb;
  float* out;
  float* mx;
  float* den;
  int* cnt;
  int* pidx;
  __nv_bfloat16* pw;
  int N;
  int C;
  bool shared;
};

// A row's outputs (global row g, tile row r): out, mx, den, its count and
// its pairs, from its list (count <= kCap; lval holds the logits when
// have_logits) or by the dense passes (an overflow row: no pairs); a row
// outside the mask outputs zeros.
__device__ void finish_row(const AttendOut& o, const double* ps, int ps_stride, int r,
                           size_t g, bool live, float thr, int count, const int* lidx,
                           float* lval, bool have_logits, int lane) {
  float* out_row = o.out + g * o.C;
  float m = 0.f, d = 0.f;
  int listed = 0;               // pairs written out: the count of a list row
  if (!live) {
    if (lane < o.C) out_row[lane] = 0.f;
    if (lane + 32 < o.C) out_row[lane + 32] = 0.f;
  } else if (count <= kCap) {
    attend_from_list(ps, ps_stride, r, lidx, lval, count, o.valb, have_logits, o.C, lane,
                     out_row, m, d);
    listed = count;
  } else {
    attend_dense(ps, ps_stride, r, o.selb, o.valb, o.nb, thr, o.N, o.C, o.shared, lane,
                 out_row, m, d);
  }
  // lane e % 32 wrote lval[e] (the bf16 weight) itself
  for (int e = lane; e < kCap; e += 32) {
    const bool in = e < listed;
    o.pidx[g * kCap + e] = in ? lidx[e] : -1;
    o.pw[g * kCap + e] = __float2bfloat16_rn(in ? lval[e] : 0.f);
  }
  if (lane == 0) {
    o.mx[g] = m;
    o.den[g] = d;
    o.cnt[g] = live ? count : 0;
  }
}

// the outputs of a tile of `rows` rows without a valid row: zeros, no pairs
__device__ void empty_tile(const AttendOut& o, size_t row0, int rows, int threads) {
  for (int i = threadIdx.x; i < rows * o.C; i += threads) o.out[row0 * o.C + i] = 0.f;
  for (int i = threadIdx.x; i < rows; i += threads) {
    o.mx[row0 + i] = 0.f;
    o.den[row0 + i] = 0.f;
    o.cnt[row0 + i] = 0;
  }
  for (int i = threadIdx.x; i < rows * kCap; i += threads) {
    o.pidx[row0 * kCap + i] = -1;
    o.pw[row0 * kCap + i] = __float2bfloat16_rn(0.f);
  }
}

// The dense sweep of K8 and K9: a tile of kARows = 16 pillar rows of one
// scan, 4 warps (the tile size is this one constant; 64 rows take 16
// warps). The scan's table streams through shared memory in 128-point
// chunks as bf16 (rows padded to 144 B), double-buffered with cp.async, one
// barrier a chunk; warp w owns rows 16 (w % (kARows / 16)).. and points
// 32 (w / (kARows / 16)).. of each chunk (4 tiles of 16 x 8), its pillar
// fragments widened to f64 in registers for the whole sweep and each table
// fragment widened as it is loaded, the scores on DMMA of depth kDK
// (mma.sync m16n8k{4,8,16} .f64). Within a DMMA's kDK channels, lane q
// takes the kDK / 4 consecutive channels from (kDK / 4) q, so its table
// fragment is one load; the sums are exact in any order. A lane holds the
// exact f64 dots of rows rb + g + 8 (e / 2) with points nc + 8 j + 2 q +
// e % 2 (j < 4, e < 4), g = lane / 4, q = lane % 4, nc the chunk's first
// point plus the warp's 32 cb. They go to on_chunk(nc, j0, acc) in JW
// columns (acc[j - j0][e], j0 <= j < j0 + JW) at a time: JW = 2 halves the
// accumulators a lane holds.
constexpr int kARows = 16;
constexpr int kARowGroups = kARows / 16;        // warps over a chunk's rows
constexpr int kAWarps = 4 * kARowGroups;        // and 4 over its points
constexpr int kAThreads = 32 * kAWarps;
constexpr int kABlocks = 512 / kAThreads;       // blocks an SM (the registers)
constexpr int kDK = 16;                         // the depth of a DMMA: 4, 8 or 16
constexpr int kAKSteps = kMaxC / kDK;
constexpr int kACS = kMaxC + 8;                 // bf16 row stride of a chunk (144 B)
constexpr int kAChunkElems = kChunk * kACS;
static_assert(kARows % 16 == 0 && kChunk == 4 * 32, "warp w: 16 rows x 32 points");
static_assert(2 * kAChunkElems * 2 >= kMaxC * kARows * 8, "the pillar tile fits the chunks");
static_assert(2 * kAChunkElems * 2 >= kARows * kChunk * 4, "K8's maxima fit the chunks");

template <int JW, class OnChunk>
__device__ __forceinline__ void dmma_sweep(const __nv_bfloat16* __restrict__ pill,
                                           const __nv_bfloat16* __restrict__ tab,
                                           __nv_bfloat16* chunks, int b, int v0, int V,
                                           int N, int C, OnChunk&& on_chunk) {
  static_assert(4 % JW == 0, "JW columns of 4");
  constexpr int kRun = kDK / 4;                 // consecutive channels a lane holds
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int rb = (warp % kARowGroups) * 16, cb = (warp / kARowGroups) * 32;
  hvpr::stage_rows<kChunk, kACS, kAThreads>(tab, chunks, 0, N, C);
  // a[ks][i]: row rb + g + 8 (i % 2), channel ks kDK + kRun q + i / 2; C % 8
  // == 0, so a lane's run of channels is all inside C or all past it
  double a[kAKSteps][kDK / 2];
#pragma unroll
  for (int ks = 0; ks < kAKSteps; ++ks)
#pragma unroll
    for (int i = 0; i < kDK / 2; ++i) {
      const int v = v0 + rb + g + 8 * (i % 2), c = ks * kDK + kRun * q + i / 2;
      a[ks][i] = v < V && c < C ? hvpr::widen(pill[((size_t)b * V + v) * C + c]) : 0.0;
    }
  const int n_chunks = (N + kChunk - 1) / kChunk;
  for (int ch = 0; ch < n_chunks; ++ch) {
    hvpr::cp_async_wait<0>();
    __syncthreads();                    // chunk ch is in; no warp reads chunk ch - 1
    if (ch + 1 < n_chunks)
      hvpr::stage_rows<kChunk, kACS, kAThreads>(
          tab, chunks + ((ch + 1) & 1) * kAChunkElems, (ch + 1) * kChunk, N, C);
    const __nv_bfloat16* tb = chunks + (ch & 1) * kAChunkElems;
#pragma unroll
    for (int j0 = 0; j0 < 4; j0 += JW) {
      double acc[JW][4];
#pragma unroll
      for (int j = 0; j < JW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0;
#pragma unroll
      for (int ks = 0; ks < kAKSteps; ++ks) {
        if (ks * kDK < C) {
          const int c = ks * kDK + kRun * q;
#pragma unroll
          for (int j = 0; j < JW; ++j) {
            double bf[kRun];
            if (c < C) {
              hvpr::widen_run<kDK>(tb + (cb + 8 * (j0 + j) + g) * kACS + c, bf);
            } else {
#pragma unroll
              for (int i = 0; i < kRun; ++i) bf[i] = 0.0;
            }
            hvpr::dmma16(acc[j], a[ks], bf);
          }
        }
      }
      on_chunk(ch * kChunk + cb, j0, acc);
    }
  }
}

// ----------------------------------------------------------------- K8

// A tile's thresholds. Lane (g, q) of warp w keeps the bucket maxima of
// rows rb + 8 i + g and buckets cb + 8 j + 2 q + h: the buckets of the
// points it holds in every chunk. Each score is f32(dot) + neg, masked
// points included (neg ~ -1e30); points past N score exactly -1e30, as the
// plain version's padding. kTJW: the columns of scores a lane holds at once
// (of 4); 2 leaves registers for the maxima without a spill at 4 blocks an
// SM, and measured as fast as 4 on an H100 when K8 moved onto K9's sweep.
constexpr int kTJW = 2;

__global__ void __launch_bounds__(kAThreads, kABlocks)
bucket_threshold_kernel(const __nv_bfloat16* __restrict__ pill,
                        const __nv_bfloat16* __restrict__ tab,
                        const float* __restrict__ neg, const bool* __restrict__ row_mask,
                        float* __restrict__ th_out, int V, int N, int C, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* chunks = reinterpret_cast<__nv_bfloat16*>(smem);    // 2 x kAChunkElems
  float* bm = reinterpret_cast<float*>(smem);           // kARows x kChunk, after the sweep
  const int b = blockIdx.y, v0 = blockIdx.x * kARows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;

  if (!tile_has_valid<kARows>(row_mask, b, v0, V)) {
    const int t = threadIdx.x;
    if (t < kARows && v0 + t < V) th_out[(size_t)b * V + v0 + t] = 0.f;
    return;
  }
  const float* nb = neg + (size_t)b * N;
  float bmax[2][4][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) bmax[i][j][0] = bmax[i][j][1] = -CUDART_INF_F;

  dmma_sweep<kTJW>(pill, tab + (size_t)b * N * C, chunks, b, v0, V, N, C,
                   [&](int nc, int j0, const double (&acc)[kTJW][4]) {
#pragma unroll
    for (int j = 0; j < kTJW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = nc + 8 * (j0 + j) + 2 * q + h;
        const float ng = n < N ? __ldg(nb + n) : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float s = n < N ? __fadd_rn(__double2float_rn(acc[j][2 * i + h]), ng) : kNeg;
          bmax[i][j0 + j][h] = fmaxf(bmax[i][j0 + j][h], s);
        }
      }
  });
  __syncthreads();                      // no warp reads the last chunk
  const int rb = (warp % kARowGroups) * 16, cb = (warp / kARowGroups) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        bm[(rb + 8 * i + g) * kChunk + cb + 8 * j + 2 * q + h] = bmax[i][j][h];
  __syncthreads();
  for (int r = warp; r < kARows; r += kAWarps) {
    const float th = kth_largest(bm + r * kChunk, k, lane);
    const int v = v0 + r;
    if (lane == 0 && v < V) th_out[(size_t)b * V + v] = row_valid(row_mask, b, v, V) ? th : 0.f;
  }
}

// K9's dense sweep over a tile (dmma_sweep). A chunk's picks enter each
// row's list in index order: a row's picks within a warp are one 32-bit
// mask (OR of its 4 lanes), and the 4 warps over a row's points add in
// point order by their counts in shared memory. Then a warp finishes
// kARows / kAWarps = 4 rows.
__global__ void __launch_bounds__(kAThreads, kABlocks)
masked_attend_fwd_kernel(const __nv_bfloat16* __restrict__ pill,
                         const __nv_bfloat16* __restrict__ sel,
                         const __nv_bfloat16* __restrict__ val,
                         const float* __restrict__ neg, const float* __restrict__ th,
                         const bool* __restrict__ row_mask, float* __restrict__ out,
                         float* __restrict__ mx_out, float* __restrict__ den_out,
                         int* __restrict__ cnt_out, int* __restrict__ pidx_out,
                         __nv_bfloat16* __restrict__ pw_out, int V, int N, int C,
                         int shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* chunks = reinterpret_cast<__nv_bfloat16*>(smem);    // 2 x kAChunkElems
  double* ps = reinterpret_cast<double*>(smem);        // kMaxC x kARows, after the sweep
  int* lidx = reinterpret_cast<int*>(chunks + 2 * kAChunkElems);     // kARows x kCap
  float* lval = reinterpret_cast<float*>(lidx + kARows * kCap);      // kARows x kCap
  int* part = reinterpret_cast<int*>(lval + kARows * kCap);          // kARows x 4
  int* total = part + kARows * 4;                                    // kARows
  const int b = blockIdx.y, v0 = blockIdx.x * kARows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const size_t row0 = (size_t)b * V + v0;
  const __nv_bfloat16* selb = sel + (size_t)b * N * C;
  const float* nb = neg + (size_t)b * N;
  const AttendOut o{selb, val + (size_t)b * N * C, nb, out, mx_out, den_out, cnt_out,
                    pidx_out, pw_out, N, C, shared != 0};

  if (!tile_has_valid<kARows>(row_mask, b, v0, V)) {
    empty_tile(o, row0, min(kARows, V - v0), kAThreads);
    return;
  }
  if (threadIdx.x < kARows) total[threadIdx.x] = 0;

  // the warp's rows rb + 8 i + g; a row outside the mask selects nothing
  const int rb = (warp % kARowGroups) * 16, cg = warp / kARowGroups;
  float thr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = v0 + rb + 8 * i + g;
    thr[i] = row_valid(row_mask, b, v, V) ? th[(size_t)b * V + v] : CUDART_INF_F;
  }

  dmma_sweep<4>(pill, selb, chunks, b, v0, V, N, C,
                [&](int nc, int, const double (&acc)[4][4]) {
    // scores, picks, and each row's mask of picks over the warp's 32 points
    float sc[2][4][2];
    unsigned mask[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = nc + 8 * j + 2 * q + h;
        const float ng = n < N ? nb[n] : kNeg;
        const bool ok = n < N && ng == 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float s = __fadd_rn(__double2float_rn(acc[j][2 * i + h]), ng);
          sc[i][j][h] = s;
          if (ok && s >= thr[i]) mask[i] |= 1u << (8 * j + 2 * q + h);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mask[i] |= __shfl_xor_sync(kFull, mask[i], 1);
      mask[i] |= __shfl_xor_sync(kFull, mask[i], 2);
      if (q == 0) part[(rb + 8 * i + g) * 4 + cg] = __popc(mask[i]);
    }
    __syncthreads();                    // every warp's counts; last chunk's totals
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (mask[i] == 0u) continue;
      const int r = rb + 8 * i + g;
      int base = total[r];
      for (int w4 = 0; w4 < cg; ++w4) base += part[r * 4 + w4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int bit = 8 * j + 2 * q + h;
          if (mask[i] >> bit & 1u) {
            const int pos = base + __popc(mask[i] & ((1u << bit) - 1u));
            if (pos < kCap) {
              lidx[r * kCap + pos] = nc + 8 * j + 2 * q + h;
              lval[r * kCap + pos] = sc[i][j][h];
            }
          }
        }
    }
    __syncthreads();                    // the counts are read
    if (threadIdx.x < kARows) {
      const int* pr = part + threadIdx.x * 4;
      total[threadIdx.x] += pr[0] + pr[1] + pr[2] + pr[3];
    }
  });
  __syncthreads();                      // the totals; the chunk buffers are free
  load_pillars<kARows, kAThreads>(pill, ps, b, v0, V, C);
  __syncthreads();

  // each warp finishes 4 rows
  for (int r = warp; r < kARows; r += kAWarps) {
    const int v = v0 + r;
    if (v >= V) continue;
    const bool live = row_valid(row_mask, b, v, V);
    finish_row(o, ps, kARows, r, row0 + r, live, live ? th[row0 + r] : 0.f,
               live ? total[r] : 0, lidx + r * kCap, lval + r * kCap, shared != 0, lane);
  }
}

// K9's pair pass: a call handed the selection of an earlier call over the
// same pillars, selection table, neg, thresholds and row mask (the fused
// step's split call, after the shared one) makes no dense sweep. A tile of
// kRows rows, a warp 4 rows: a row with at most kCap selected points takes
// their indices from the selection and computes its logits over them only;
// an overflow row (more) takes the dense passes.
__global__ void __launch_bounds__(kThreads)
masked_attend_pairs_kernel(const __nv_bfloat16* __restrict__ pill,
                           const __nv_bfloat16* __restrict__ sel,
                           const __nv_bfloat16* __restrict__ val,
                           const float* __restrict__ neg, const float* __restrict__ th,
                           const bool* __restrict__ row_mask,
                           const int* __restrict__ sel_cnt, const int* __restrict__ sel_idx,
                           float* __restrict__ out, float* __restrict__ mx_out,
                           float* __restrict__ den_out, int* __restrict__ cnt_out,
                           int* __restrict__ pidx_out, __nv_bfloat16* __restrict__ pw_out,
                           int V, int N, int C, int shared) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ps = reinterpret_cast<double*>(smem);                   // kMaxC x kRows
  int* lidx = reinterpret_cast<int*>(ps + kMaxC * kRows);          // kRows x kCap
  float* lval = reinterpret_cast<float*>(lidx + kRows * kCap);     // kRows x kCap
  const int b = blockIdx.y, v0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row0 = (size_t)b * V + v0;
  const __nv_bfloat16* selb = sel + (size_t)b * N * C;
  const __nv_bfloat16* valb = val + (size_t)b * N * C;
  const float* nb = neg + (size_t)b * N;
  const AttendOut o{selb, valb, nb, out, mx_out, den_out, cnt_out, pidx_out, pw_out, N, C,
                    shared != 0};

  if (!tile_has_valid(row_mask, b, v0, V)) {
    empty_tile(o, row0, min(kRows, V - v0), kThreads);
    return;
  }
  load_pillars(pill, ps, b, v0, V, C);
  __syncthreads();
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int v = v0 + r;
    if (v >= V) continue;
    const bool live = row_valid(row_mask, b, v, V);
    const int count = live ? sel_cnt[row0 + r] : 0;
    int* li = lidx + r * kCap;
    float* lv = lval + r * kCap;
    if (live && count <= kCap) {
      // the logits of the listed points (the shared call's: its scores)
      for (int e = lane; e < count; e += 32) {
        const int n = sel_idx[(row0 + r) * kCap + e];
        li[e] = n;
        lv[e] = shared ? __fadd_rn(dot_row(ps, kRows, r, selb + (size_t)n * C, C), nb[n])
                       : dot_row(ps, kRows, r, valb + (size_t)n * C, C);
      }
    }
    __syncwarp();
    finish_row(o, ps, kRows, r, row0 + r, live, live ? th[row0 + r] : 0.f, count, li, lv,
               true, lane);
  }
}

// ----------------------------------------------------------------- K10

// exclusive prefix of each thread's value over the block (kScanThreads
// threads); *total gets the block's sum
__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, off);
    if (lane >= off) inc += y;
  }
  __syncthreads();                           // a previous call's reads are done
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;                     // inclusive over the warps
  }
  __syncthreads();
  *total = warp_sums[kScanThreads / 32 - 1];
  return inc - x + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// the pairs a row wrote out: its count if it finished from its list, else 0
__device__ __forceinline__ int listed_pairs(const int* __restrict__ cnt, int row) {
  const int c = cnt[row];
  return c <= kCap ? c : 0;
}

// (a) counts[b N + n] = the number of listed pairs of point n of scan b; a
// warp a row
__global__ void __launch_bounds__(kThreads)
pair_count_kernel(const int* __restrict__ pidx, const int* __restrict__ cnt,
                  int* __restrict__ counts, int rows, int V, int N) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int c = listed_pairs(cnt, row);
  int* cb = counts + (size_t)(row / V) * N;
  for (int e = lane; e < c; e += 32) atomicAdd(cb + pidx[(size_t)row * kCap + e], 1);
}

// the counts array is zero-padded to a multiple of kScanTile
__host__ __device__ __forceinline__ int scan_padded(int n) {
  return (n + kScanTile - 1) / kScanTile * kScanTile;
}

// (b1) per tile of kScanTile counts, their sum and how many are long
// (> kPiece); a thread 4 counts
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(const int* __restrict__ counts, int* __restrict__ tile_sum,
                  int* __restrict__ tile_long) {
  const int4 v = reinterpret_cast<const int4*>(counts)[blockIdx.x * kScanThreads + threadIdx.x];
  int total, total_long;
  block_exclusive_scan(v.x + v.y + v.z + v.w, &total);
  block_exclusive_scan((v.x > kPiece) + (v.y > kPiece) + (v.z > kPiece) + (v.w > kPiece),
                       &total_long);
  if (threadIdx.x == 0) {
    tile_sum[blockIdx.x] = total;
    tile_long[blockIdx.x] = total_long;
  }
}

// (b2) offsets[i] = counts[0] + ... + counts[i - 1] for i <= n, a copy of
// offsets[0..n) in cursor, and the long points in ascending order with
// their number; a block a tile, after the tiles before it
__global__ void __launch_bounds__(kScanThreads)
scan_write_kernel(const int* __restrict__ counts, const int* __restrict__ tile_sum,
                  const int* __restrict__ tile_long, int* __restrict__ offsets,
                  int* __restrict__ cursor, int* __restrict__ longp, int* __restrict__ n_long,
                  int n) {
  int base = 0, lbase = 0;
  for (int t = 0; t < (int)blockIdx.x; ++t) {
    base += tile_sum[t];
    lbase += tile_long[t];
  }
  const int i0 = blockIdx.x * kScanTile + 4 * threadIdx.x;
  const int4 v = reinterpret_cast<const int4*>(counts)[i0 / 4];
  const int c[4] = {v.x, v.y, v.z, v.w};
  int total, total_long;
  int run = base + block_exclusive_scan(c[0] + c[1] + c[2] + c[3], &total);
  int lpos = lbase + block_exclusive_scan((c[0] > kPiece) + (c[1] > kPiece) +
                                          (c[2] > kPiece) + (c[3] > kPiece), &total_long);
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int i = i0 + h;
    if (i < n) {
      offsets[i] = run;
      cursor[i] = run;
      if (c[h] > kPiece) longp[lpos++] = i;
    }
    run += c[h];
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) {
    offsets[n] = base + total;
    *n_long = lbase + total_long;
  }
}

// (c) each listed pair's key, row * kCap + slot, into its point's segment
// (in no fixed order); a warp a row
__global__ void __launch_bounds__(kThreads)
pair_place_kernel(const int* __restrict__ pidx, const int* __restrict__ cnt,
                  int* __restrict__ cursor, int* __restrict__ keys, int rows, int V, int N) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int c = listed_pairs(cnt, row);
  int* cb = cursor + (size_t)(row / V) * N;
  for (int e = lane; e < c; e += 32) {
    const int key = row * kCap + e;
    keys[atomicAdd(cb + pidx[key], 1)] = key;
  }
}

// (d) each short segment (at most kPiece keys) sorted by key into `sorted`:
// a pair's place is the number of smaller keys in its segment (the keys of
// a segment are distinct); a warp a row, a lane a pair
__global__ void __launch_bounds__(kThreads)
pair_rank_kernel(const int* __restrict__ pidx, const int* __restrict__ cnt,
                 const int* __restrict__ offsets, const int* __restrict__ keys,
                 int* __restrict__ sorted, int rows, int V, int N) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int c = listed_pairs(cnt, row);
  const int* ob = offsets + (size_t)(row / V) * N;
  for (int e = lane; e < c; e += 32) {
    const int key = row * kCap + e;
    const int p = pidx[key];
    const int o = ob[p], len = ob[p + 1] - o;
    if (len > kPiece) continue;                 // a long segment: (d')
    int rank = 0;
    for (int j = 0; j < len; ++j) rank += keys[o + j] < key;
    sorted[o + rank] = key;
  }
}

// (d') each long segment sorted by key into `sorted`, a block a segment: a
// counting sort by row, as a point is listed at most once a row. Per window
// of kSlotWindow rows of its scan, the block marks each listed row's slot
// (slot + 1, a byte) in shared memory, then writes the marked rows in order.
__global__ void __launch_bounds__(kLongThreads)
long_sort_kernel(const int* __restrict__ offsets, const int* __restrict__ keys,
                 int* __restrict__ sorted, const int* __restrict__ longp,
                 const int* __restrict__ n_long, int V, int N) {
  __shared__ __align__(16) unsigned char slot[kSlotWindow];
  constexpr int kPer = kSlotWindow / kLongThreads;             // 32 slots a thread
  static_assert(kLongThreads == kScanThreads, "block_exclusive_scan");
  const int nl = *n_long;
  for (int s = blockIdx.x; s < nl; s += gridDim.x) {
    const int p = longp[s];
    const int o = offsets[p], len = offsets[p + 1] - o;
    const int row0 = p / N * V;                                // the scan's first row
    int done = 0;
    for (int w0 = 0; w0 < V; w0 += kSlotWindow) {
      for (int i = threadIdx.x; i < kSlotWindow / 16; i += kLongThreads)
        reinterpret_cast<uint4*>(slot)[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
      for (int i = threadIdx.x; i < len; i += kLongThreads) {
        const int key = keys[o + i];
        const int v = key / kCap - row0 - w0;
        if (0 <= v && v < kSlotWindow) slot[v] = (unsigned char)(key % kCap + 1);
      }
      __syncthreads();
      const int j0 = threadIdx.x * kPer;
      int mine = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) mine += slot[j0 + j] != 0;
      int total;
      int pos = done + block_exclusive_scan(mine, &total);
      for (int j = 0; j < kPer && mine > 0; ++j) {
        const int e = slot[j0 + j];
        if (e != 0) {
          sorted[o + pos++] = (row0 + w0 + j0 + j) * kCap + e - 1;
          --mine;
        }
      }
      done += total;
      __syncthreads();                                         // slot is cleared next
    }
  }
}

// (e) per scan (a block), its overflow rows (inside the mask, past the
// list) in ascending order as global rows b V + v, and their number
__global__ void __launch_bounds__(kScanThreads)
overflow_rows_kernel(const int* __restrict__ cnt, int* __restrict__ ovf,
                     int* __restrict__ n_ovf, int V) {
  const int b = blockIdx.x;
  const int per = (V + kScanThreads - 1) / kScanThreads;
  const int v0 = min(V, (int)threadIdx.x * per), v1 = min(V, v0 + per);
  const int* cb = cnt + (size_t)b * V;
  int s = 0;
  for (int v = v0; v < v1; ++v) s += cb[v] > kCap;
  int total;
  int pos = block_exclusive_scan(s, &total);
  for (int v = v0; v < v1; ++v)
    if (cb[v] > kCap) ovf[(size_t)b * V + pos++] = b * V + v;
  if (threadIdx.x == 0) n_ovf[b] = total;
}

// bf16(a) . bf16(x) over C channels, f64 in channel order (as dot_row),
// rounded to f32
__device__ __forceinline__ float dot_bf16(const __nv_bfloat16* __restrict__ a,
                                          const __nv_bfloat16* __restrict__ x, int C) {
  double acc = 0.0;
  for (int c = 0; c < C; ++c)
    acc = fma((double)__bfloat162float(a[c]), (double)__bfloat162float(x[c]), acc);
  return __double2float_rn(acc);
}

// what (f) needs of one point: its scan's overflow rows and the inputs that
// recompute their weights at this point, and where the sums go
struct PointCtx {
  const int* ovf;                // the scan's overflow rows, ascending global rows
  int n_ovf;
  const __nv_bfloat16* pill;
  const __nv_bfloat16* srow;     // the point's row of sel and of val
  const __nv_bfloat16* vrow;
  float ng;
  const float* th;
  const float* mx;
  const float* den;
  const __nv_bfloat16* pw;
  const float* dout;
  int C;
  bool shared;
};

__device__ __forceinline__ PointCtx point_ctx(int pt, int b, int V, int C, int shared,
                                              const int* ovf, const int* n_ovf,
                                              const __nv_bfloat16* pill,
                                              const __nv_bfloat16* sel,
                                              const __nv_bfloat16* val, const float* neg,
                                              const float* th, const float* mx,
                                              const float* den, const __nv_bfloat16* pw,
                                              const float* dout) {
  return PointCtx{ovf + (size_t)b * V, n_ovf[b], pill, sel + (size_t)pt * C,
                  val + (size_t)pt * C, neg[pt], th, mx, den, pw, dout, C, shared != 0};
}

// overflow row `row`'s bf16 weight at the point, as K9's dense pass made it
__device__ __forceinline__ float overflow_weight(const PointCtx& x, int row) {
  const __nv_bfloat16* prow = x.pill + (size_t)row * x.C;
  const float s = __fadd_rn(dot_bf16(prow, x.srow, x.C), x.ng);
  if (x.ng != 0.f || !(s >= x.th[row])) return 0.f;
  const float l = x.shared ? s : dot_bf16(prow, x.vrow, x.C);
  const float e = expf(__fsub_rn(l, x.mx[row]));
  const float d = x.den[row];
  return d > 0.f ? bf16_round(__fdiv_rn(e, fmaxf(d, 1e-30f))) : 0.f;
}

__device__ __forceinline__ void add_row(const PointCtx& x, int row, float w, int lane,
                                        double& a0, double& a1) {
  const float* d = x.dout + (size_t)row * x.C;
  if (lane < x.C) a0 = fma((double)w, (double)d[lane], a0);
  if (lane + 32 < x.C) a1 = fma((double)w, (double)d[lane + 32], a1);
}

// adds to (a0, a1) bf16(w) * dout over the point's listed rows keys[0..nk)
// (sorted) and its overflow rows ovf[t0..t1), merged in ascending row
// order; one warp, lane t owning channels t and t + 32. The overflow rows
// come in batches of 32: lane j holds row tb + j and its weight.
__device__ __forceinline__ void reduce_rows(const PointCtx& x, const int* __restrict__ keys,
                                            int nk, int t0, int t1, int lane, double& a0,
                                            double& a1) {
  int tb = t0, t = t0, o_row = INT_MAX;
  float o_w = 0.f;
  if (t0 < t1 && tb + lane < t1) {
    o_row = x.ovf[tb + lane];
    o_w = overflow_weight(x, o_row);
  }
  int next = t < t1 ? __shfl_sync(kFull, o_row, 0) : INT_MAX;
  for (int base = 0;; base += 32) {
    int row = INT_MAX;
    float w = 0.f;
    if (base + lane < nk) {
      const int key = keys[base + lane];
      row = key / kCap;
      w = __bfloat162float(x.pw[key]);
    }
    const int n_here = base < nk ? min(32, nk - base) : 0;
    const int last = n_here > 0 ? __shfl_sync(kFull, row, n_here - 1) : INT_MAX;
    if (next > last) {
      // no overflow row before the batch's last: the batch alone, kAhead
      // rows' dout loads in flight before their multiply-adds
      for (int q0 = 0; q0 < n_here; q0 += kAhead) {
        float d0[kAhead], d1[kAhead], wq[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const int q = min(q0 + u, n_here - 1);
          const int rq = __shfl_sync(kFull, row, q);
          wq[u] = q0 + u < n_here ? __shfl_sync(kFull, w, q) : 0.f;
          const float* d = x.dout + (size_t)rq * x.C;
          d0[u] = lane < x.C ? d[lane] : 0.f;
          d1[u] = lane + 32 < x.C ? d[lane + 32] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (q0 + u < n_here) {
            a0 = fma((double)wq[u], (double)d0[u], a0);
            a1 = fma((double)wq[u], (double)d1[u], a1);
          }
        }
      }
      // done, or the overflow rows past the last key in the next round
      if (n_here < 32 && next == INT_MAX) break;
      continue;
    }
    for (int q = 0; q <= n_here; ++q) {
      const int rq = q < n_here ? __shfl_sync(kFull, row, q) : INT_MAX;
      // the overflow rows before rq
      while (next < rq) {
        const float wo = __shfl_sync(kFull, o_w, t - tb);
        if (wo != 0.f) add_row(x, next, wo, lane, a0, a1);
        if (++t < t1 && t - tb == 32) {
          tb = t;
          o_row = INT_MAX;
          o_w = 0.f;
          if (tb + lane < t1) {
            o_row = x.ovf[tb + lane];
            o_w = overflow_weight(x, o_row);
          }
        }
        next = t < t1 ? __shfl_sync(kFull, o_row, t - tb) : INT_MAX;
      }
      if (q < n_here) add_row(x, rq, __shfl_sync(kFull, w, q), lane, a0, a1);
    }
    if (n_here < 32) break;
  }
}

__device__ __forceinline__ void store_dval(float* __restrict__ dval, int pt, int C, int lane,
                                           double a0, double a1) {
  float* dst = dval + (size_t)pt * C;
  if (lane < C) dst[lane] = bf16_round(__double2float_rn(a0));
  if (lane + 32 < C) dst[lane + 32] = bf16_round(__double2float_rn(a1));
}

// (f) dval[b, n] = bf16(sum over the rows v that select point n, ascending,
// of bf16(w[v, n]) * dout[b, v]) for the short points (at most kPiece
// listed rows); a warp a point. Listed rows take w from the pairs; overflow
// rows recompute it as K9's dense pass made it (score, selection, logit,
// exp, the saved mx and den).
__global__ void __launch_bounds__(kThreads)
pair_reduce_kernel(const int* __restrict__ offsets, const int* __restrict__ sorted,
                   const __nv_bfloat16* __restrict__ pw, const int* __restrict__ ovf,
                   const int* __restrict__ n_ovf, const float* __restrict__ dout,
                   const __nv_bfloat16* __restrict__ pill,
                   const __nv_bfloat16* __restrict__ sel,
                   const __nv_bfloat16* __restrict__ val, const float* __restrict__ neg,
                   const float* __restrict__ th, const float* __restrict__ mx,
                   const float* __restrict__ den, float* __restrict__ dval, int B, int V,
                   int N, int C, int shared) {
  const int pt = blockIdx.x * kWarps + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (pt >= B * N) return;
  const int o = offsets[pt], len = offsets[pt + 1] - o;
  if (len > kPiece) return;                        // a long point: (f')
  const PointCtx x = point_ctx(pt, pt / N, V, C, shared, ovf, n_ovf, pill, sel, val, neg, th,
                               mx, den, pw, dout);
  double a0 = 0.0, a1 = 0.0;
  reduce_rows(x, sorted + o, len, 0, x.n_ovf, lane, a0, a1);
  store_dval(dval, pt, C, lane, a0, a1);
}

// first i in [0, n) with rows[i] >= row (rows ascending), else n
__device__ __forceinline__ int lower_bound(const int* rows, int n, int row) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rows[mid] < row) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// (f') the long points, a block a point: its sorted rows cut into pieces of
// kPiece, warp w reducing pieces w, w + 32, ... (each in ascending row order,
// with the overflow rows that fall between its first row and the next
// piece's), the warps' f64 sums then added in warp order
__global__ void __launch_bounds__(kLongThreads)
long_reduce_kernel(const int* __restrict__ offsets, const int* __restrict__ sorted,
                   const int* __restrict__ longp, const int* __restrict__ n_long,
                   const __nv_bfloat16* __restrict__ pw, const int* __restrict__ ovf,
                   const int* __restrict__ n_ovf, const float* __restrict__ dout,
                   const __nv_bfloat16* __restrict__ pill,
                   const __nv_bfloat16* __restrict__ sel,
                   const __nv_bfloat16* __restrict__ val, const float* __restrict__ neg,
                   const float* __restrict__ th, const float* __restrict__ mx,
                   const float* __restrict__ den, float* __restrict__ dval, int V, int N,
                   int C, int shared) {
  __shared__ double part[kLongWarps][2][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nl = *n_long;
  for (int s = blockIdx.x; s < nl; s += gridDim.x) {
    const int pt = longp[s];
    const int o = offsets[pt], len = offsets[pt + 1] - o;
    const PointCtx x = point_ctx(pt, pt / N, V, C, shared, ovf, n_ovf, pill, sel, val, neg,
                                 th, mx, den, pw, dout);
    const int pieces = (len + kPiece - 1) / kPiece;
    double a0 = 0.0, a1 = 0.0;
    for (int pc = warp; pc < pieces; pc += kLongWarps) {
      const int k0 = pc * kPiece, k1 = min(len, k0 + kPiece);
      const int t0 = pc == 0 ? 0 : lower_bound(x.ovf, x.n_ovf, sorted[o + k0] / kCap);
      const int t1 = pc == pieces - 1 ? x.n_ovf
                                      : lower_bound(x.ovf, x.n_ovf, sorted[o + k1] / kCap);
      reduce_rows(x, sorted + o + k0, k1 - k0, t0, t1, lane, a0, a1);
    }
    part[warp][0][lane] = a0;
    part[warp][1][lane] = a1;
    __syncthreads();
    if (warp == 0) {
      double s0 = 0.0, s1 = 0.0;
      for (int w = 0; w < kLongWarps; ++w) {
        s0 += part[w][0][lane];
        s1 += part[w][1][lane];
      }
      store_dval(dval, pt, C, lane, s0, s1);
    }
    __syncthreads();                               // part is reused next round
  }
}

constexpr size_t kThreshSmem = 2 * kAChunkElems * 2;
constexpr size_t kFwdSmem = 2 * kAChunkElems * 2 + (sizeof(int) + sizeof(float)) * kARows * kCap
                            + sizeof(int) * kARows * 5;
constexpr size_t kPairsSmem = sizeof(double) * kMaxC * kRows
                              + (sizeof(int) + sizeof(float)) * kRows * kCap;

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
  const dim3 grid((V + kARows - 1) / kARows, B);
  bucket_threshold_kernel<<<grid, kAThreads, kThreshSmem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(pill), static_cast<const __nv_bfloat16*>(tab), neg,
      static_cast<const bool*>(row_mask), th, V, N, C, k);
  return (int)cudaGetLastError();
}

// pillars (B, V, C), sel and val (B, N, C) bf16 (one pointer when shared);
// neg (B, N), th (B, V) f32; row_mask (B, V) bool; out (B, V, C),
// mx, den (B, V) f32 and cnt (B, V) int32 out (0 outside the mask); the
// pairs pidx (B, V, kCap) int32 and pw (B, V, kCap) bf16 out. C % 8 == 0.
extern "C" int hvpr_masked_attend_fwd(const void* pill, const void* sel, const void* val,
                                      const float* neg, const float* th, const void* row_mask,
                                      float* out, float* mx, float* den, int* cnt, int* pidx,
                                      void* pw, int B, int V, int N, int C, int shared,
                                      void* stream) {
  cudaError_t e = cudaFuncSetAttribute(masked_attend_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((V + kARows - 1) / kARows, B);
  masked_attend_fwd_kernel<<<grid, kAThreads, kFwdSmem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(pill), static_cast<const __nv_bfloat16*>(sel),
      static_cast<const __nv_bfloat16*>(val), neg, th, static_cast<const bool*>(row_mask),
      out, mx, den, cnt, pidx, static_cast<__nv_bfloat16*>(pw), V, N, C, shared);
  return (int)cudaGetLastError();
}

// The same outputs from the selection (sel_cnt (B, V), sel_idx (B, V, kCap)
// int32: the cnt and pidx of an earlier call over the same pillars, sel,
// neg, th and row_mask) without the dense sweep.
extern "C" int hvpr_masked_attend_pairs(const void* pill, const void* sel, const void* val,
                                        const float* neg, const float* th,
                                        const void* row_mask, const int* sel_cnt,
                                        const int* sel_idx, float* out, float* mx,
                                        float* den, int* cnt, int* pidx, void* pw, int B,
                                        int V, int N, int C, int shared, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(masked_attend_pairs_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kPairsSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((V + kRows - 1) / kRows, B);
  masked_attend_pairs_kernel<<<grid, kThreads, kPairsSmem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(pill), static_cast<const __nv_bfloat16*>(sel),
      static_cast<const __nv_bfloat16*>(val), neg, th, static_cast<const bool*>(row_mask),
      sel_cnt, sel_idx, out, mx, den, cnt, pidx, static_cast<__nv_bfloat16*>(pw), V, N, C,
      shared);
  return (int)cudaGetLastError();
}

// int32 scratch K10 needs (see hvpr_masked_attend_bwd)
extern "C" long long hvpr_masked_attend_bwd_work(int B, int V, int N) {
  const long long points = (long long)B * N, rows = (long long)B * V;
  const long long tiles = scan_padded(B * N) / kScanTile;
  return scan_padded(B * N) + 2 * tiles + 3 * points + 2 + 2 * rows * kCap + rows + B;
}

// the forward's inputs, its mx, den, cnt and pairs; dout (B, V, C) f32;
// dval (B, N, C) f32 out, each value bf16-exact; work: int32 scratch of
// hvpr_masked_attend_bwd_work(B, V, N) elements. B * V * kCap < 2^31.
extern "C" int hvpr_masked_attend_bwd(const void* pill, const void* sel, const void* val,
                                      const float* neg, const float* th, const float* mx,
                                      const float* den, const int* cnt, const int* pidx,
                                      const void* pw, const float* dout, float* dval,
                                      int* work, int B, int V, int N, int C, int shared,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = B * V, points = B * N;
  const int padded = scan_padded(points), tiles = padded / kScanTile;
  int* counts = work;                                  // padded, zeros past points
  int* tile_sum = counts + padded;                     // tiles
  int* tile_long = tile_sum + tiles;                   // tiles
  int* offsets = tile_long + tiles;                    // points + 1
  int* cursor = offsets + points + 1;                  // points
  int* longp = cursor + points;                        // points
  int* n_long = longp + points;                        // 1
  int* keys = n_long + 1;                              // rows * kCap
  int* sorted = keys + (size_t)rows * kCap;            // rows * kCap
  int* ovf = sorted + (size_t)rows * kCap;             // rows
  int* n_ovf = ovf + rows;                             // B
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int) * padded, st);
  if (e != cudaSuccess) return (int)e;
  const int row_blocks = (rows + kWarps - 1) / kWarps;
  const auto* pwb = static_cast<const __nv_bfloat16*>(pw);
  const auto* pb = static_cast<const __nv_bfloat16*>(pill);
  const auto* sb = static_cast<const __nv_bfloat16*>(sel);
  const auto* vb = static_cast<const __nv_bfloat16*>(val);
  pair_count_kernel<<<row_blocks, kThreads, 0, st>>>(pidx, cnt, counts, rows, V, N);
  scan_tiles_kernel<<<tiles, kScanThreads, 0, st>>>(counts, tile_sum, tile_long);
  scan_write_kernel<<<tiles, kScanThreads, 0, st>>>(counts, tile_sum, tile_long, offsets,
                                                    cursor, longp, n_long, points);
  pair_place_kernel<<<row_blocks, kThreads, 0, st>>>(pidx, cnt, cursor, keys, rows, V, N);
  pair_rank_kernel<<<row_blocks, kThreads, 0, st>>>(pidx, cnt, offsets, keys, sorted, rows,
                                                    V, N);
  long_sort_kernel<<<kLongBlocks, kLongThreads, 0, st>>>(offsets, keys, sorted, longp, n_long,
                                                         V, N);
  overflow_rows_kernel<<<B, kScanThreads, 0, st>>>(cnt, ovf, n_ovf, V);
  pair_reduce_kernel<<<(points + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      offsets, sorted, pwb, ovf, n_ovf, dout, pb, sb, vb, neg, th, mx, den, dval, B, V, N, C,
      shared);
  long_reduce_kernel<<<kLongBlocks, kLongThreads, 0, st>>>(offsets, sorted, longp, n_long,
                                                           pwb, ovf, n_ovf, dout, pb, sb, vb,
                                                           neg, th, mx, den, dval, V, N, C,
                                                           shared);
  return (int)cudaGetLastError();
}
