// Rotated BEV intersection and IoU of every pair of two box sets (K13).
//
// Replaces: no TPU kernel. hvpr_tpu/ops/rotated_iou.py computes the pair
// planes with XLA, and the port's plain version (ops/rotated_iou.py,
// _edge_contributions) writes each of its ~500 intermediates as a full
// (N, M) plane: at the NMS's 4,096 x 4,096 candidates, 67 MB an op.
//
// What it computes, bit for bit: the plain version's Green's-theorem clip.
// The wrapper hands over the boxes and torch's cos and sin of their
// headings; each block makes its boxes' records from them (the corners,
// the four half-planes ux, uy, c, the area) with box_to_corners_bev's and
// half_planes' operations. For a pair (P, Q) the kernel sums cross(s_e,
// t_e) over P's edges clipped to Q's closed half-planes (with the
// anti-parallel boundary test) and over Q's edges clipped to P's open
// ones. Every product, sum and quotient is rounded one by one as its torch
// op rounds it (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: no FMA
// contraction, IEEE division), torch.maximum and torch.minimum are
// max.NaN / min.NaN, all in the plain version's order; then the epilogue:
// clamp(0.5 * two_area, min=0), the min with the smaller area, and for the
// IoU overlap / clamp(area_a + area_b - overlap, min=1e-6). The sine and
// cosine stay torch's: a cosf built here need not round as torch's does.
//
// What bounds it on the H100: the plane's bytes written, 4 N M (67 MB at
// 4,096^2, 0.02 ms at 3.35 TB/s), since most pairs of a scan's candidates
// lie metres apart. The full clip costs ~500 f32 operations and up to 32
// divisions a pair, the exact rejection test below ~130; both are needed
// only for the few pairs that lie close.
//
// Design:
// - A block owns a tile of 4,096 pairs, kTI rows (boxes of the first set)
//   by kTJ columns (of the second), kTJ = 32, 64 or 128 by M, so a thin
//   set (anchors x a few ground-truth boxes) wastes few lanes. Both tiles'
//   records are made into shared memory (25 floats, an odd stride), and
//   each box's area, centre and reach into a float4 beside them. Lanes run
//   along M: each warp covers 32 consecutive columns of one row, so its
//   stores are coalesced and the row's float4 is a broadcast read; a
//   thread keeps its column's in registers.
// - A bounding-circle test first, ~10 operations a pair: a pair whose
//   centres lie further apart than the sum of the boxes' reaches gets the
//   epilogue of a zero area, written at once. Why that is exact: a box
//   with sides dx, dy >= max(0.01, 2e-3 k), k = |x| + |y| + (dx + dy) / 2
//   <= 1e6, has reach 1.5 (dx + dy) / 2 + 5e-3 k + 0.5 (infinite for any
//   other box). Beyond that distance d, the edge of P whose outward normal
//   lies within 45 degrees of d has every corner of Q outside it by more
//   than 0.7 + 3.5e-3 (k_P + k_Q) metres, and the same holds for an edge
//   of Q and the corners of P. The rounding of the corners, of the edge
//   vectors (relative to an edge no shorter than 2e-3 k) and of f moves a
//   signed distance by less than 1.1e-3 (k_P + k_Q) metres, and eps over
//   an edge of 0.01 m or more is 0.1 m at most; so f < -eps holds for the
//   four corners of one box against one half-plane of the other, both
//   ways, the condition of the exact test below.
// - The other pairs are compacted into a shared-memory queue (a thread
//   marks its near pairs in a word, a scan over the warp places them, one
//   shared atomic a warp), and every thread of the block takes one in turn
//   for the exact test, from the same signed distances f = ux y - uy x + c
//   the clip computes: when against one half-plane of Q every corner of P
//   has f < -eps (the closed clip's "out") and against one half-plane of P
//   every corner of Q has f < +eps (the open clip's "out"), every clipped
//   edge of the plain version is empty and both sums are exactly +0.
// - The pairs that fail it go to a second queue and take the full clip,
//   again a thread a pair, so the few near pairs do not leave 31 lanes of
//   a warp idle. One thread a block adds that queue's length to a device
//   counter when the wrapper hands one (the pairs clipped).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 4096;                  // pairs a block: kTI * kTJ
constexpr int kMaxBoxes = kPairs / 32 + 32;   // kTI + kTJ at most: 160
constexpr int kRec = 25;                      // floats a record (24 used)
// record layout: corners x0 y0 x1 y1 x2 y2 x3 y3 (CCW), then ux[4], uy[4],
// c[4] of the half-plane of each edge, the area dx * dy, the centre, and
// the reach of the bounding-circle test
constexpr int kUx = 8, kUy = 12, kC = 16, kArea = 20, kX = 21, kY = 22, kReach = 23;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPairs / kThreads <= 32, "a thread's pairs of a tile are the bits of a word");
static_assert(kThreads % 128 == 0, "a thread keeps one column at every tile width");

// the plain version's margins, as torch compares a float32 tensor with a
// Python float: the double rounded to float
__device__ __forceinline__ float eps() { return static_cast<float>(1e-3); }
__device__ __forceinline__ float eps_div() { return static_cast<float>(1e-6); }

// torch.maximum / torch.minimum on the card: NaN if either side is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch.clamp(v, min=lo): NaN stays, else fmaxf
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// the signed distance of (x, y) to a half-plane: ux * y - uy * x + c
__device__ __forceinline__ float side(float ux, float uy, float c, float x, float y) {
  return __fadd_rn(__fsub_rn(__fmul_rn(ux, y), __fmul_rn(uy, x)), c);
}

// sum over the 4 edges of box p (record) of cross(s_e, t_e), the edge
// clipped to box q's half-planes: _edge_contributions(cp, cq, strict)
template <bool kStrict>
__device__ float edge_sum(const float* __restrict__ p, const float* __restrict__ q) {
  float f[4][4];                        // f[h][k]: corner k of p against plane h of q
#pragma unroll
  for (int h = 0; h < 4; ++h)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      f[h][k] = side(q[kUx + h], q[kUy + h], q[kC + h], p[2 * k], p[2 * k + 1]);
  float total = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int e1 = (e + 1) & 3;
    const float ax = p[2 * e], ay = p[2 * e + 1];
    const float dxe = __fsub_rn(p[2 * e1], ax), dye = __fsub_rn(p[2 * e1 + 1], ay);
    float t_lo = 0.0f, t_hi = 1.0f;
    bool empty = false, degenerate = false;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float fa = f[h][e], fb = f[h][e1];
      const bool a_out = kStrict ? fa < eps() : fa < -eps();
      const bool b_out = kStrict ? fb < eps() : fb < -eps();
      if (!kStrict) {
        const bool anti =
            __fadd_rn(__fmul_rn(q[kUx + h], dxe), __fmul_rn(q[kUy + h], dye)) < 0.0f;
        const bool near = fabsf(fa) < eps() && fabsf(fb) < eps();
        degenerate = degenerate || (near && anti);
      }
      empty = empty || (a_out && b_out);
      // t_cross enters only where exactly one end is out; elsewhere the
      // plain version takes max(t_lo, 0) and min(t_hi, 1)
      float lo = 0.0f, hi = 1.0f;
      if (a_out != b_out) {
        const float denom = __fsub_rn(fa, fb);
        const float t_cross = __fdiv_rn(fa, denom == 0.0f ? 1.0f : denom);
        if (a_out) lo = t_cross; else hi = t_cross;
      }
      t_lo = max_nan(t_lo, lo);
      t_hi = min_nan(t_hi, hi);
    }
    const bool keep = !empty && !degenerate && t_hi > t_lo;
    const float p0x = __fadd_rn(ax, __fmul_rn(t_lo, dxe));
    const float p0y = __fadd_rn(ay, __fmul_rn(t_lo, dye));
    const float p1x = __fadd_rn(ax, __fmul_rn(t_hi, dxe));
    const float p1y = __fadd_rn(ay, __fmul_rn(t_hi, dye));
    const float cross = __fsub_rn(__fmul_rn(p0x, p1y), __fmul_rn(p0y, p1x));
    total = __fadd_rn(total, keep ? cross : 0.0f);
  }
  return total;
}

// boxes_overlap_bev's epilogue, and boxes_iou_bev's division when kIou
template <bool kIou>
__device__ __forceinline__ float epilogue(float two_area, float area_a, float area_b) {
  const float overlap =
      min_nan(clamp_min(__fmul_rn(two_area, 0.5f), 0.0f), min_nan(area_a, area_b));
  if (!kIou) return overlap;
  const float denom = clamp_min(__fsub_rn(__fadd_rn(area_a, area_b), overlap), eps_div());
  // a zero over a positive denominator is that zero, sign and all: most
  // pairs skip the division
  return overlap == 0.0f && denom > 0.0f ? overlap : __fdiv_rn(overlap, denom);
}

// every corner of p out of one half-plane of q: f < -eps (closed) or
// f < +eps (open)
template <bool kStrict>
__device__ __forceinline__ bool outside(const float* __restrict__ pc,
                                        const float* __restrict__ q) {
  bool out = false;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    bool all = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float f = side(q[kUx + h], q[kUy + h], q[kC + h], pc[2 * k], pc[2 * k + 1]);
      all = all && (kStrict ? f < eps() : f < -eps());
    }
    out = out || all;
  }
  return out;
}

// a box's record from its row [x, y, z, dx, dy, dz, heading, ...] and
// torch's cos and sin of the heading: box_to_corners_bev, half_planes and
// dx * dy, op by op; then the reach of the bounding-circle test
__device__ void make_record(const float* __restrict__ box, float cosa, float sina,
                            float* __restrict__ rec) {
  const float x = box[0], y = box[1], dx = box[3], dy = box[4];
  // lx = [dx, dx, -dx, -dx] * 0.5, ly = [-dy, dy, dy, -dy] * 0.5
  const float hx = __fmul_rn(dx, 0.5f), nhx = __fmul_rn(-dx, 0.5f);
  const float hy = __fmul_rn(dy, 0.5f), nhy = __fmul_rn(-dy, 0.5f);
  const float lx[4] = {hx, hx, nhx, nhx};
  const float ly[4] = {nhy, hy, hy, nhy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rec[2 * k] = __fsub_rn(__fadd_rn(x, __fmul_rn(lx[k], cosa)), __fmul_rn(ly[k], sina));
    rec[2 * k + 1] = __fadd_rn(__fadd_rn(y, __fmul_rn(lx[k], sina)), __fmul_rn(ly[k], cosa));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int k1 = (k + 1) & 3;
    const float ux = __fsub_rn(rec[2 * k1], rec[2 * k]);
    const float uy = __fsub_rn(rec[2 * k1 + 1], rec[2 * k + 1]);
    rec[kUx + k] = ux;
    rec[kUy + k] = uy;
    rec[kC + k] = __fsub_rn(__fmul_rn(uy, rec[2 * k]), __fmul_rn(ux, rec[2 * k + 1]));
  }
  rec[kArea] = __fmul_rn(dx, dy);
  rec[kX] = x;
  rec[kY] = y;
  // the reach (see the note above); NaN and inf fail every comparison
  const float scale = fabsf(x) + fabsf(y) + hx + hy;
  const float least = fmaxf(0.01f, 2e-3f * scale);
  const bool proven = scale <= 1e6f && dx >= least && dy >= least &&
                      fabsf(cosa) <= 1.0f && fabsf(sina) <= 1.0f;
  rec[kReach] = proven ? 1.5f * (hx + hy) + 5e-3f * scale + 0.5f : INFINITY;
}

// append the pairs t + i kThreads for the bits i of `bits` to a
// shared-memory queue: a scan of the counts over the warp and one shared
// atomic a warp; every lane of the warp calls it
__device__ __forceinline__ void enqueue(unsigned bits, uint16_t* queue, int* length) {
  const int lane = threadIdx.x & 31;
  const int mine = __popc(bits);
  int upto = mine;                      // inclusive scan over the lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, upto, d);
    if (lane >= d) upto += v;
  }
  int base = 0;
  if (lane == 31 && upto > 0) base = atomicAdd(length, upto);
  int at = __shfl_sync(kFull, base, 31) + upto - mine;
  for (; bits != 0u; bits &= bits - 1u)
    queue[at++] = static_cast<uint16_t>(threadIdx.x + (__ffs(bits) - 1) * kThreads);
}

template <bool kIou>
__global__ void __launch_bounds__(kThreads)
rotated_iou_kernel(const float* __restrict__ a, int a_stride, const float* __restrict__ a_cos,
                   const float* __restrict__ a_sin, const float* __restrict__ b,
                   int b_stride, const float* __restrict__ b_cos,
                   const float* __restrict__ b_sin, float* __restrict__ out, int n, int m,
                   int tj_log2, unsigned long long* __restrict__ clipped) {
  __shared__ float sbox[kMaxBoxes * kRec];    // the row tile's records, then the column tile's
  __shared__ float4 sdisc[kMaxBoxes];         // (area, x, y, reach) of each, for the circle test
  __shared__ uint16_t near_queue[kPairs];     // pairs left to the exact test
  __shared__ uint16_t clip_queue[kPairs];     // pairs left to the clip
  __shared__ int n_near, n_clip;

  const int tj = 1 << tj_log2, ti = kPairs >> tj_log2;
  const int i0 = blockIdx.x * ti, j0 = blockIdx.y * tj;
  const int rows = min(ti, n - i0), cols = min(tj, m - j0);
  const int t = threadIdx.x;
  float* sa = sbox;
  float* sb = sbox + ti * kRec;
  float4* disc_a = sdisc;
  float4* disc_b = sdisc + ti;
  for (int x = t; x < rows + cols; x += kThreads) {
    float* rec;
    if (x < rows) {
      const int i = i0 + x;
      rec = sa + x * kRec;
      make_record(a + static_cast<long long>(i) * a_stride, a_cos[i], a_sin[i], rec);
      disc_a[x] = make_float4(rec[kArea], rec[kX], rec[kY], rec[kReach]);
    } else {
      const int j = j0 + x - rows;
      rec = sb + (x - rows) * kRec;
      make_record(b + static_cast<long long>(j) * b_stride, b_cos[j], b_sin[j], rec);
      disc_b[x - rows] = make_float4(rec[kArea], rec[kX], rec[kY], rec[kReach]);
    }
  }
  if (t == 0) n_near = n_clip = 0;
  __syncthreads();

  // the bounding-circle test; a thread's column is fixed (kThreads is a
  // multiple of kTJ)
  const int col = t & (tj - 1);
  const bool col_in = col < cols;
  const float4 q = col_in ? disc_b[col] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float* out_col = out + j0 + col;
  unsigned near = 0u;                   // bit i: pair t + i kThreads is near
#pragma unroll 4
  for (int i = 0; i < kPairs / kThreads; ++i) {
    const int r = (t + i * kThreads) >> tj_log2;
    if (r < rows && col_in) {
      const float4 d = disc_a[r];
      const float ddx = q.y - d.y, ddy = q.z - d.z, reach = d.w + q.w;
      if (ddx * ddx + ddy * ddy > reach * reach) {
        out_col[static_cast<long long>(i0 + r) * m] = epilogue<kIou>(0.0f, d.x, q.x);
      } else {
        near |= 1u << i;
      }
    }
  }
  enqueue(near, near_queue, &n_near);
  __syncthreads();

  // the exact test on the near pairs, a thread a pair
  const int count_near = n_near;
  for (int x = t; x < count_near; x += kThreads) {
    const int p = near_queue[x];
    const int r = p >> tj_log2, c = p & (tj - 1);
    const float* pa = sa + r * kRec;
    const float* pb = sb + c * kRec;
    if (outside<false>(pa, pb) && outside<true>(pb, pa)) {
      out[static_cast<long long>(i0 + r) * m + j0 + c] =
          epilogue<kIou>(0.0f, pa[kArea], pb[kArea]);
    } else {
      clip_queue[atomicAdd(&n_clip, 1)] = static_cast<uint16_t>(p);
    }
  }
  __syncthreads();

  // the full clip of the rest, a thread a pair
  const int count_clip = n_clip;
  if (t == 0 && clipped != nullptr && count_clip > 0)
    atomicAdd(clipped, static_cast<unsigned long long>(count_clip));
  for (int x = t; x < count_clip; x += kThreads) {
    const int p = clip_queue[x];
    const int r = p >> tj_log2, c = p & (tj - 1);
    const float* pa = sa + r * kRec;
    const float* pb = sb + c * kRec;
    const float two_area = __fadd_rn(edge_sum<false>(pa, pb), edge_sum<true>(pb, pa));
    out[static_cast<long long>(i0 + r) * m + j0 + c] =
        epilogue<kIou>(two_area, pa[kArea], pb[kArea]);
  }
}

// the records alone, for holding make_record to the plain version's ops
__global__ void records_kernel(const float* __restrict__ boxes, int stride,
                               const float* __restrict__ cosa, const float* __restrict__ sina,
                               int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) make_record(boxes + static_cast<long long>(i) * stride, cosa[i], sina[i],
                         out + static_cast<long long>(i) * kRec);
}

}  // namespace

// a (n, >= 7) and b (m, >= 7) f32 boxes, rows a_stride / b_stride floats
// apart, with torch's cos and sin of each heading (n and m f32); out (n, m)
// f32: the overlap areas, or the IoUs when iou = 1. clipped: null, or an
// unsigned 64-bit device counter to which the pairs that took the full
// clip are added. Returns cudaGetLastError() after the launch (none when n
// or m is 0).
extern "C" int hvpr_rotated_iou(const float* a, int a_stride, const float* a_cos,
                                const float* a_sin, const float* b, int b_stride,
                                const float* b_cos, const float* b_sin, float* out, int n,
                                int m, int iou, unsigned long long* clipped, void* stream) {
  if (n <= 0 || m <= 0) return static_cast<int>(cudaSuccess);
  const int tj_log2 = m <= 32 ? 5 : (m <= 64 ? 6 : 7);
  const int tj = 1 << tj_log2, ti = kPairs >> tj_log2;
  const dim3 grid((n + ti - 1) / ti, (m + tj - 1) / tj);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (iou) {
    rotated_iou_kernel<true><<<grid, kThreads, 0, s>>>(a, a_stride, a_cos, a_sin, b, b_stride,
                                                       b_cos, b_sin, out, n, m, tj_log2,
                                                       clipped);
  } else {
    rotated_iou_kernel<false><<<grid, kThreads, 0, s>>>(a, a_stride, a_cos, a_sin, b, b_stride,
                                                        b_cos, b_sin, out, n, m, tj_log2,
                                                        clipped);
  }
  return static_cast<int>(cudaGetLastError());
}

// the records of n boxes into out (n, 25) f32, as the kernel makes them
extern "C" int hvpr_rotated_iou_records(const float* boxes, int stride, const float* cosa,
                                        const float* sina, int n, float* out, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  records_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(boxes, stride, cosa, sina, n, out);
  return static_cast<int>(cudaGetLastError());
}
