// Deterministic backward of a row gather (K12; not a TPU kernel).
//
// Stands in for: the backward of hvpr_tpu/ops/pointnet2.py group_points
// (:189), an XLA gather whose scatter-add backward the TPU sums in a fixed
// order. torch.gather's backward on the card is a scatter-add by float
// atomics, whose order, and so whose rounding, changes from run to run:
// the point stream's 3-NN interpolation and grouping repeat indices, and
// two train steps differed by ~3% of a point-stream gradient.
//
// What it computes: out[t] = the f32 sum, in source order, of the rows j of
// grad with index[j] == t, rounded once to grad's dtype (round to nearest
// even for bf16); zeros for a target with no row. That is an f32 index_add_
// into zeros as the CPU runs it, so the plain version's bits, on every run.
//
// What bounds it on the H100: memory. Each incoming gradient row is read
// once and each output row written once.
//
// Design. The set-up is a counting sort of the source rows by target, no
// 64-bit sort: one cooperative launch of passes with a grid barrier
// between them (one launch, not five: on the card's host each launch costs
// ~5 us, more than most passes take on the device):
//   zero   the counts and the scan's words;
//   count  integer atomics count the rows of each target (order-free, so
//          deterministic; a warp's lanes that share a target add once);
//   scan   an exclusive scan of the counts into each target's range of
//          the order (2048 targets a tile, each tile's prefix from its
//          predecessors' published sums, read back 32 at a time by a warp:
//          decoupled look-back), listing the ranges of 2-8, 9-32 and more
//          rows;
//   place  a target of one row gets it in place; an atomic cursor per
//          target puts each row of a longer range into it, in no fixed
//          order;
//   sort   ascending source rows are the source order: a thread sorts a
//          range of 2-8 rows in registers (odd-even transposition), a warp
//          one of 9-32 (a bitonic network by shuffles), a block each longer
//          one through a bitmap of source rows in shared memory (set a bit a
//          row, then read the set bits back in order), one window of 262,144
//          rows at a time.
// The sum of rows that are a multiple of 16 bytes gives a group of G lanes
// (a power of two, up to a warp) a run of consecutive targets, so that
// many targets of a few rows each keep loads in flight: the lanes cover
// the channels with 16-byte loads (4 f32 or 8 bf16), the group reads the
// run's source rows, which lie next to each other in the order, some at
// once and hands them round by shuffles, each lane keeps 8 rows' loads in
// flight and adds them strictly in order (__fadd_rn, one f32 accumulator a
// channel), and writes a target's channels once its last row is added
// (zeros for a target without rows). G covers a row (at most 32 lanes);
// the run is as long as makes ~64 rows, but short enough to give the card
// 32 warps an SM. Other rows take a thread a (target, channel), 8 of the
// target's rows in flight, the same adds.
//
// The scratch (int32 words; hvpr_gather_grad_scratch gives its size):
// offsets (targets + 1), then order (rows): target t's source rows,
// ascending, at order[offsets[t], offsets[t + 1]); then the tiles' look-back
// words, the three lists' lengths and the counts (zeroed by the first
// pass), the cursors, the three lists and the rows as placed.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanItems = 8;                     // counts a thread scans
constexpr int kScanTile = kThreads * kScanItems;  // targets a scan tile
constexpr int kSmall = 8;                         // longest range a thread sorts
constexpr int kShort = 32;                        // longest range a warp sorts
constexpr int kSetupBlocks = 2;                   // set-up blocks an SM
constexpr int kBitmapWords = 8192;                // 32 KB: 262,144 source rows
constexpr int kRows = 8;                          // rows a lane has in flight
constexpr int kRunRows = 64;                      // rows a group's run aims at
constexpr int kSumBlocks = 2;                     // sum blocks an SM: 128 registers
constexpr unsigned kFull = 0xffffffffu;

struct Layout {
  long long offsets, order, status, lists_n, count, fill, lists, perm, total;
};

Layout layout(long long rows, long long targets) {
  Layout l;
  l.offsets = 0;
  l.order = targets + 1;
  l.status = (l.order + rows + 1) & ~1LL;        // 8-byte aligned
  const long long tiles = (targets + kScanTile - 1) / kScanTile;
  l.lists_n = l.status + 2 * tiles;
  l.count = l.lists_n + 3;
  l.fill = l.count + targets;
  l.lists = l.fill + targets;                    // three lists of targets each
  l.perm = l.lists + 3 * targets;
  l.total = l.perm + rows;
  return l;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// exclusive prefix of v over the block, and the block's total
template <typename T>
__device__ __forceinline__ T block_exclusive(T v, T* s_warp, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  __syncthreads();
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? s_warp[lane] : T(0);
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const T y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  total = s_warp[kWarps - 1];
  return incl - v + (warp > 0 ? s_warp[warp - 1] : T(0));
}

// the row's target, or -1 where the row is past the end or its target
// outside [0, targets)
__device__ __forceinline__ long long target_of(const long long* index, long long j,
                                               long long rows, int targets) {
  const long long t = j < rows ? index[j] : -1;
  return t >= 0 && t < targets ? t : -1;
}

__device__ __forceinline__ void count_rows(const long long* __restrict__ index, long long rows,
                                           int targets, int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j0 = (long long)blockIdx.x * kThreads; j0 < rows; j0 += stride) {
    const long long t = target_of(index, j0 + threadIdx.x, rows, targets);
    const unsigned peers = __match_any_sync(kFull, t);
    if (t >= 0 && lane == __ffs(peers) - 1) atomicAdd(&count[t], __popc(peers));
  }
}

__device__ __forceinline__ void scan_tile(int tile, const int* __restrict__ count, int targets,
                                          int* __restrict__ offsets, int* __restrict__ fill,
                                          unsigned long long* status, int* lists_n,
                                          int* __restrict__ lists) {
  __shared__ int s_before, s_base[3];
  __shared__ int s_warp[kWarps];
  __shared__ unsigned long long s_warp64[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = (long long)tile * kScanTile + threadIdx.x * kScanItems;
  int v[kScanItems];
  int sum = 0;
  // the lists' entries of this thread, 20 bits a list (a tile has 2048)
  unsigned long long listed = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = first + i < targets ? count[first + i] : 0;
    sum += v[i];
    if (v[i] > 1) listed += 1ULL << (20 * (v[i] <= kSmall ? 0 : v[i] <= kShort ? 1 : 2));
  }
  int total;
  const int excl = block_exclusive<int>(sum, s_warp, total);
  unsigned long long listed_total;
  unsigned long long list_at =
      block_exclusive<unsigned long long>(listed, s_warp64, listed_total);
  if (warp == 0) {
    // the block's places in the three lists, in flight during the look-back
    int base = 0;
    if (lane < 3) {
      base = atomicAdd(lists_n + lane, (int)((listed_total >> (20 * lane)) & 0xfffff));
    }
    // a tile's word: flag 1 (its own sum) or 2 (its inclusive prefix) in
    // the high half, the value in the low half; the warp reads the 32
    // tiles before a window's top at once, sums back to the nearest
    // inclusive prefix, and moves the window down until it finds one
    int before = 0;
    if (tile > 0) {
      if (lane == 0) atomicExch(status + tile, (1ULL << 32) | (unsigned)total);
      for (int top = tile - 1;;) {
        const int q = top - lane;
        const unsigned long long w =
            q >= 0 ? *(volatile unsigned long long*)(status + q) : (2ULL << 32);
        const unsigned flag = (unsigned)(w >> 32);
        if (__any_sync(kFull, flag == 0)) continue;
        const unsigned inclusive = __ballot_sync(kFull, flag == 2);
        const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
        before += warp_sum(lane <= stop ? (int)(unsigned)w : 0);
        if (inclusive) break;
        top -= 32;
      }
    }
    if (lane == 0) {
      atomicExch(status + tile, (2ULL << 32) | (unsigned)(before + total));
      s_before = before;
    }
    if (lane < 3) s_base[lane] = base;
  }
  __syncthreads();
  int at = s_before + excl;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (first + i < targets) {
      offsets[first + i] = at;
      fill[first + i] = at;
    }
    at += v[i];
    if (v[i] > 1) {
      const int which = v[i] <= kSmall ? 0 : v[i] <= kShort ? 1 : 2;
      lists[(long long)which * targets + s_base[which] +
            (int)((list_at >> (20 * which)) & 0xfffff)] = (int)(first + i);
      list_at += 1ULL << (20 * which);
    }
  }
  if (first < targets && targets <= first + kScanItems) offsets[targets] = at;
}

__device__ __forceinline__ void place_rows(const long long* __restrict__ index, long long rows,
                                           int targets, const int* __restrict__ count,
                                           const int* __restrict__ offsets,
                                           int* __restrict__ fill, int* __restrict__ order,
                                           int* __restrict__ perm) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long j0 = (long long)blockIdx.x * kThreads; j0 < rows; j0 += stride) {
    const long long j = j0 + threadIdx.x;
    const long long t = target_of(index, j, rows, targets);
    const unsigned peers = __match_any_sync(kFull, t);
    const int leader = __ffs(peers) - 1;
    const bool alone = t >= 0 && count[t] == 1;
    int at = 0;
    if (t >= 0 && lane == leader) {
      at = alone ? offsets[t] : atomicAdd(&fill[t], __popc(peers));
    }
    at = __shfl_sync(kFull, at, leader);
    if (t >= 0) (alone ? order : perm)[at + __popc(peers & ((1u << lane) - 1u))] = (int)j;
  }
}

// ranges of 2-8 rows: a thread each; of 9-32: a warp each; longer: a block
// each; the three lists as the scan left them
__device__ __forceinline__ void sort_ranges(const int* __restrict__ offsets,
                                            const int* __restrict__ perm, int* __restrict__ order,
                                            int targets, const int* __restrict__ lists_n,
                                            const int* __restrict__ lists) {
  __shared__ unsigned bits[kBitmapWords];
  __shared__ int s_warp[kWarps];
  __shared__ int2 s_range[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long thread = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long threads = (long long)gridDim.x * kThreads;

  const int n_small = lists_n[0];
  for (long long k = thread; k < n_small; k += threads) {
    const int t = lists[k];
    const int begin = offsets[t], len = offsets[t + 1] - begin;
    int v[kSmall];
#pragma unroll
    for (int i = 0; i < kSmall; ++i) v[i] = i < len ? perm[begin + i] : INT_MAX;
#pragma unroll
    for (int round = 0; round < kSmall; ++round) {
#pragma unroll
      for (int i = round & 1; i + 1 < kSmall; i += 2) {
        const int a = min(v[i], v[i + 1]), b = max(v[i], v[i + 1]);
        v[i] = a;
        v[i + 1] = b;
      }
    }
#pragma unroll
    for (int i = 0; i < kSmall; ++i) {
      if (i < len) order[begin + i] = v[i];
    }
  }

  const int n_mid = lists_n[1];
  for (long long k = thread >> 5; k < n_mid; k += threads >> 5) {
    const int t = lists[(long long)targets + k];
    const int begin = offsets[t], len = offsets[t + 1] - begin;
    const int width = len <= 16 ? 16 : 32;
    int x = lane < len ? perm[begin + lane] : INT_MAX;
    for (int kk = 2; kk <= width; kk <<= 1) {
      for (int j = kk >> 1; j > 0; j >>= 1) {
        const int y = __shfl_xor_sync(kFull, x, j);
        x = (((lane & kk) == 0) == ((lane & j) == 0)) ? min(x, y) : max(x, y);
      }
    }
    if (lane < len) order[begin + lane] = x;
  }

  const int n_long = lists_n[2];
  for (int k = blockIdx.x; k < n_long; k += gridDim.x) {
    const int t = lists[2LL * targets + k];
    const int begin = offsets[t], len = offsets[t + 1] - begin;
    int lo = INT_MAX, hi = -1;
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const int id = perm[begin + i];
      lo = min(lo, id);
      hi = max(hi, id);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFull, lo, off));
      hi = max(hi, __shfl_xor_sync(kFull, hi, off));
    }
    __syncthreads();
    if (lane == 0) s_range[warp] = make_int2(lo, hi);
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      lo = min(lo, s_range[w].x);
      hi = max(hi, s_range[w].y);
    }
    int written = 0;
    for (long long w0 = lo; w0 <= hi; w0 += 32LL * kBitmapWords) {
      const int words = (int)min((long long)kBitmapWords, (hi - w0) / 32 + 1);
      for (int i = threadIdx.x; i < words; i += kThreads) bits[i] = 0u;
      __syncthreads();
      for (int i = threadIdx.x; i < len; i += kThreads) {
        const long long d = perm[begin + i] - w0;
        if (d >= 0 && d < 32LL * words) atomicOr(&bits[d >> 5], 1u << (d & 31));
      }
      __syncthreads();
      // each thread reads back a run of words, at its prefix of set bits
      const int per = (words + kThreads - 1) / kThreads;
      const int wb = min(words, (int)threadIdx.x * per), we = min(words, wb + per);
      int mine = 0;
      for (int w = wb; w < we; ++w) mine += __popc(bits[w]);
      int total;
      int at = begin + written + block_exclusive<int>(mine, s_warp, total);
      for (int w = wb; w < we; ++w) {
        for (unsigned b = bits[w]; b; b &= b - 1u) {
          order[at++] = (int)(w0 + 32 * w + __ffs(b) - 1);
        }
      }
      written += total;
      __syncthreads();
    }
  }
}

// the set-up's passes in one cooperative launch, a grid barrier between
// them: zero the counts, count, scan (tiles in index order over the
// blocks, so a tile's look-back waits only on tiles that run), place, sort
__global__ void __launch_bounds__(kThreads)
k12_setup(const long long* __restrict__ index, long long rows, int targets, int* scratch,
          Layout l) {
  cg::grid_group grid = cg::this_grid();
  const long long zero = l.fill - l.status;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < zero;
       i += (long long)gridDim.x * kThreads) {
    scratch[l.status + i] = 0;
  }
  grid.sync();
  count_rows(index, rows, targets, scratch + l.count);
  grid.sync();
  const int tiles = (targets + kScanTile - 1) / kScanTile;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    scan_tile(tile, scratch + l.count, targets, scratch + l.offsets, scratch + l.fill,
              reinterpret_cast<unsigned long long*>(scratch + l.status), scratch + l.lists_n,
              scratch + l.lists);
  }
  grid.sync();
  place_rows(index, rows, targets, scratch + l.count, scratch + l.offsets, scratch + l.fill,
             scratch + l.order, scratch + l.perm);
  grid.sync();
  sort_ranges(scratch + l.offsets, scratch + l.perm, scratch + l.order, targets,
              scratch + l.lists_n, scratch + l.lists);
}

// kVec consecutive elements of a row a lane: their raw load, their f32 sum
// and their store
template <bool kBf16, int kVec>
struct Lanes;

template <>
struct Lanes<false, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const void* p, long long e) {
    return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) + e));
  }
  static __device__ __forceinline__ void add(float (&a)[4], Raw r) {
    a[0] = __fadd_rn(a[0], r.x);
    a[1] = __fadd_rn(a[1], r.y);
    a[2] = __fadd_rn(a[2], r.z);
    a[3] = __fadd_rn(a[3], r.w);
  }
  static __device__ __forceinline__ void store(void* p, long long e, const float (&a)[4]) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + e) = make_float4(a[0], a[1], a[2], a[3]);
  }
};

template <>
struct Lanes<true, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const void* p, long long e) {
    return __ldg(reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(p) + e));
  }
  static __device__ __forceinline__ void add2(float& a0, float& a1, unsigned w) {
    a0 = __fadd_rn(a0, __uint_as_float(w << 16));
    a1 = __fadd_rn(a1, __uint_as_float(w & 0xffff0000u));
  }
  static __device__ __forceinline__ void add(float (&a)[8], Raw r) {
    add2(a[0], a[1], r.x);
    add2(a[2], a[3], r.y);
    add2(a[4], a[5], r.z);
    add2(a[6], a[7], r.w);
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  static __device__ __forceinline__ void store(void* p, long long e, const float (&a)[8]) {
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p) + e) =
        make_uint4(pack(a[0], a[1]), pack(a[2], a[3]), pack(a[4], a[5]), pack(a[6], a[7]));
  }
};

template <>
struct Lanes<false, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const void* p, long long e) {
    return __ldg(static_cast<const float*>(p) + e);
  }
  static __device__ __forceinline__ void add(float (&a)[1], Raw r) { a[0] = __fadd_rn(a[0], r); }
  static __device__ __forceinline__ void store(void* p, long long e, const float (&a)[1]) {
    static_cast<float*>(p)[e] = a[0];
  }
};

template <>
struct Lanes<true, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const void* p, long long e) {
    return __ldg(static_cast<const unsigned short*>(p) + e);
  }
  static __device__ __forceinline__ void add(float (&a)[1], Raw r) {
    a[0] = __fadd_rn(a[0], __uint_as_float((unsigned)r << 16));
  }
  static __device__ __forceinline__ void store(void* p, long long e, const float (&a)[1]) {
    static_cast<__nv_bfloat16*>(p)[e] = __float2bfloat16_rn(a[0]);
  }
};

// a group of kG lanes sums a run of per_group targets, a lane kVec
// channels of a row (16 bytes) a pass
template <bool kBf16, int kVec, int kG>
__global__ void __launch_bounds__(kThreads, kSumBlocks)
k12_sum(const void* __restrict__ grad, const int* __restrict__ offsets,
        const int* __restrict__ order, void* __restrict__ out, int targets, int C,
        int per_group) {
  using L = Lanes<kBf16, kVec>;
  constexpr int kChunk = kG > kRows ? kG : kRows;  // source rows read at once
  constexpr int kIds = kChunk / kG;                 // of them a lane holds
  const int lane = threadIdx.x & 31, gl = lane & (kG - 1);
  const unsigned gmask = kG == 32 ? kFull : ((1u << (kG & 31)) - 1u) << (lane - gl);
  const long long group = ((long long)blockIdx.x * kThreads + threadIdx.x) / kG;
  const long long t0 = group * per_group;
  if (t0 >= targets) return;
  const long long t1 = min(t0 + (long long)per_group, (long long)targets);
  const int begin = offsets[t0], end = offsets[t1];
  for (int c0 = 0; c0 < C; c0 += kG * kVec) {
    const int c = c0 + gl * kVec;
    const bool on = c < C;
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
    long long t = t0;
    int t_end = offsets[t0 + 1];
    for (int p0 = begin; p0 < end; p0 += kChunk) {
      const int m = min(kChunk, end - p0);
      int id[kIds];
#pragma unroll
      for (int k = 0; k < kIds; ++k) {
        const int i = k * kG + gl;
        id[k] = i < m ? order[p0 + i] : 0;
      }
      // kIds > 1 only where kChunk == kRows: one pass, r == u
      for (int r0 = 0; r0 < m; r0 += kRows) {
        typename L::Raw raw[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int r = r0 + u;
          const int row = __shfl_sync(gmask, id[kIds == 1 ? 0 : u / kG],
                                      kIds == 1 ? r : u % kG, kG);
          if (on && r < m) raw[u] = L::load(grad, (long long)row * C + c);
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int p = p0 + r0 + u;
          if (p < end) {
            while (p >= t_end) {          // target t has all its rows
              if (on) L::store(out, t * C + c, acc);
#pragma unroll
              for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
              ++t;
              t_end = offsets[t + 1];
            }
            if (on) L::add(acc, raw[u]);
          }
        }
      }
    }
    for (; t < t1; ++t) {
      if (on) L::store(out, t * C + c, acc);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
    }
  }
}

// rows that are not a multiple of 16 bytes: a thread a (target, channel),
// kRows of the target's rows in flight
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
k12_sum_narrow(const void* __restrict__ grad, const int* __restrict__ offsets,
               const int* __restrict__ order, void* __restrict__ out, long long targets,
               int C) {
  using L = Lanes<kBf16, 1>;
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= targets * C) return;
  const long long t = e / C;
  const int c = (int)(e - t * C);
  const int end = offsets[t + 1];
  float acc[1] = {0.0f};
  for (int p0 = offsets[t]; p0 < end; p0 += kRows) {
    typename L::Raw raw[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (p0 + u < end) raw[u] = L::load(grad, (long long)order[p0 + u] * C + c);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (p0 + u < end) L::add(acc, raw[u]);
    }
  }
  L::store(out, e, acc);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// blocks of the set-up: as many as stay resident, up to kSetupBlocks an SM
int setup_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k12_setup, kThreads, 0);
    blocks = sm_count() * (per_sm < kSetupBlocks ? per_sm : kSetupBlocks);
  }
  return blocks;
}

int setup(const long long* index, int* scratch, long long rows, int targets,
          cudaStream_t s) {
  Layout l = layout(rows, targets);
  void* args[] = {&index, &rows, &targets, &scratch, &l};
  return (int)cudaLaunchCooperativeKernel((const void*)k12_setup, setup_blocks(), kThreads,
                                          args, 0, s);
}

template <bool kBf16, int kVec, int kG>
void launch_sum(const void* grad, const int* scratch, void* out, long long targets, int C,
                long long per_group, cudaStream_t s) {
  const long long threads = (targets + per_group - 1) / per_group * kG;
  k12_sum<kBf16, kVec, kG><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                             s>>>(grad, scratch, scratch + targets + 1, out, (int)targets, C,
                                  (int)per_group);
}

// 16-byte rows: the group width g, lanes enough for a row, a power of two
// up to 32; the run, ~kRunRows rows, but groups enough for 32 warps an SM.
// Other rows: a thread a (target, channel)
template <bool kBf16>
void sum(const void* grad, const int* scratch, void* out, long long rows, long long targets,
         int C, int vec, cudaStream_t s) {
  if (!vec) {
    const long long threads = targets * C;
    k12_sum_narrow<kBf16><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                            s>>>(grad, scratch, scratch + targets + 1, out, targets, C);
    return;
  }
  constexpr int kVec = kBf16 ? 8 : 4;
  const int lanes = (C + kVec - 1) / kVec;
  int g = 1;
  while (g < lanes && g < 32) g <<= 1;
  const long long fill_groups = (long long)sm_count() * 32 * (32 / g);
  long long per = targets / fill_groups;
  const long long per_rows = rows > 0 ? kRunRows * targets / rows : targets;
  if (per_rows < per) per = per_rows;
  if (per < 1) per = 1;
  switch (g) {
    case 1: launch_sum<kBf16, kVec, 1>(grad, scratch, out, targets, C, per, s); break;
    case 2: launch_sum<kBf16, kVec, 2>(grad, scratch, out, targets, C, per, s); break;
    case 4: launch_sum<kBf16, kVec, 4>(grad, scratch, out, targets, C, per, s); break;
    case 8: launch_sum<kBf16, kVec, 8>(grad, scratch, out, targets, C, per, s); break;
    case 16: launch_sum<kBf16, kVec, 16>(grad, scratch, out, targets, C, per, s); break;
    default: launch_sum<kBf16, kVec, 32>(grad, scratch, out, targets, C, per, s);
  }
}

}  // namespace

// int32 words of scratch that a call over `rows` gathered rows into
// `targets` rows needs.
extern "C" long long hvpr_gather_grad_scratch(long long rows, long long targets) {
  return layout(rows, targets).total;
}

// The set-up alone: fills the scratch's offsets (targets + 1) and order
// (its first offsets[targets] words). index (rows,) int64; a row whose
// target lies outside [0, targets) is left out. Returns cudaGetLastError().
extern "C" int hvpr_gather_grad_ranges(const long long* index, int* scratch, long long rows,
                                       int targets, void* stream) {
  if (targets == 0) return (int)cudaSuccess;
  return setup(index, scratch, rows, targets, static_cast<cudaStream_t>(stream));
}

// grad (rows, C) f32 (bf16 = 0) or bf16 (bf16 = 1), the gathered rows'
// gradient; index (rows,) int64, each row's target (rows outside [0,
// targets) are left out); scratch of hvpr_gather_grad_scratch words; out
// (targets, C) in grad's dtype. vec = 1: grad's rows start 16-byte aligned
// and C is a multiple of 4 (f32) or 8 (bf16). Returns cudaGetLastError()
// after the launches.
extern "C" int hvpr_gather_grad(const void* grad, const long long* index, int* scratch,
                                void* out, long long rows, int targets, int C, int bf16,
                                int vec, void* stream) {
  if (targets == 0 || C == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = setup(index, scratch, rows, targets, s);
  if (err != 0) return err;
  if (bf16) {
    sum<true>(grad, scratch, out, rows, targets, C, vec, s);
  } else {
    sum<false>(grad, scratch, out, rows, targets, C, vec, s);
  }
  return (int)cudaGetLastError();
}
