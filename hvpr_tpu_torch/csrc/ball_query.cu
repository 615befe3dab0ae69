// Bucketed ball query (kernel K4), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel hvpr_tpu/ops/pn2_select.py:135 (`_bucket_sweep`,
// mode 'ball', called by `ball_query_bucket` :164), which streams the point
// axis once per block of centres, keeps a 128-lane running minimum of the
// in-radius point index per bucket (index mod 128), and leaves the final
// nsample-smallest top-k to XLA.
//
// Points are visited in index order, so the first `nsample` distinct
// buckets a centre hits are exactly its `nsample` smallest bucket keys: the
// sweep records each new bucket's first hit directly into `idx` and stops
// once it has `nsample`, which fuses the 128-lane top-k into the sweep and
// ends it early for dense neighbourhoods.
//
// Design: a warp takes one centre, its 32 lanes 32 consecutive points from
// a base that is a multiple of 32, so the 32 points fall in one 32-bucket
// word of the centre's 128-bit set of seen buckets (word (base / 32) % 4,
// bit `lane`); the set is 4 words, the same in every lane. A group of 32 is
// one ballot of the in-radius hits; the new buckets are `hits & ~seen[w]`,
// and lane t writes its point to slot found + popc(new & lanes below t).
// A lane loads the 4 groups of a 128-point chunk at once (12 coordinate and
// 4 mask loads in flight), and the warp leaves after the chunk in which its
// centre has `nsample` buckets. No barrier: each warp leaves at its own
// time, the point stream comes through L1/L2 (196 KB of coordinates a
// 16,384-point scan). The two-radius form (one sweep for both radii of an
// MSG level: one distance, a ballot, seen set and output per radius) leaves
// when both radii are full.
//
// Bound: ~9 f32 operations per centre-point pair a centre needs (3 sub, 3
// mul, 2 add, 1 compare) at 67 TFLOP/s f32; in practice the issue rate of
// ~20 warp instructions per 32 pairs.
//
// Exactness: the squared distance is ((dx*dx + dy*dy) + dz*dz) with every
// product and sum rounded on its own (__fmul_rn/__fadd_rn: no FMA
// contraction), the plain version's order, so points at the radius boundary
// select the same way in both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                    // centres per block
constexpr int kThreads = 32 * kWarps;
constexpr int kBuckets = 128;
constexpr int kGroups = kBuckets / 32;       // groups of 32 points in a chunk
constexpr unsigned kFull = 0xffffffffu;

// one radius of a sweep: r2 = f32(r * r), nsample <= kBuckets, and its
// outputs idx (B, S, nsample) and cnt (B, S) int32
struct Radius {
  float r2;
  int nsample;
  int* idx;
  int* cnt;
};

template <int NR>
struct Radii {
  Radius r[NR];
};

template <int NR>
__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centres,
                  const unsigned char* __restrict__ mask, const Radii<NR> rr, int n,
                  int s) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y, q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= s) return;                                    // the whole warp
  const size_t row = (size_t)b * s + q;
  const float* pts = xyz + (size_t)b * n * 3;
  const unsigned char* valid = mask + (size_t)b * n;
  const float cx = centres[row * 3 + 0], cy = centres[row * 3 + 1], cz = centres[row * 3 + 2];
  const unsigned below = (1u << lane) - 1u;              // lanes below this one

  uint32_t seen[NR][kGroups];
  int found[NR], first[NR], nsample[NR];
  float r2[NR];
  int* out[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int w = 0; w < kGroups; ++w) seen[r][w] = 0u;
    found[r] = 0;
    first[r] = 0;
    nsample[r] = rr.r[r].nsample;
    r2[r] = rr.r[r].r2;
    out[r] = rr.r[r].idx + row * nsample[r];
  }

  for (int base = 0; base < n; base += kBuckets) {
    float d2[kGroups];
    bool ok[kGroups];
#pragma unroll
    for (int w = 0; w < kGroups; ++w) {
      const int p = base + 32 * w + lane;
      float x = 0.f, y = 0.f, z = 0.f;
      ok[w] = false;
      if (p < n) {
        x = pts[(size_t)p * 3 + 0];
        y = pts[(size_t)p * 3 + 1];
        z = pts[(size_t)p * 3 + 2];
        ok[w] = valid[p] != 0;
      }
      const float dx = __fsub_rn(cx, x), dy = __fsub_rn(cy, y), dz = __fsub_rn(cz, z);
      d2[w] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    }
    bool more = false;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
#pragma unroll
      for (int w = 0; w < kGroups; ++w) {
        const uint32_t fresh = __ballot_sync(kFull, ok[w] && d2[w] < r2[r]) & ~seen[r][w];
        if (fresh) {
          if (found[r] == 0) first[r] = base + 32 * w + __ffs(fresh) - 1;
          const int slot = found[r] + __popc(fresh & below);
          if ((fresh >> lane & 1u) && slot < nsample[r]) out[r][slot] = base + 32 * w + lane;
          seen[r][w] |= fresh;
          found[r] = min(found[r] + __popc(fresh), nsample[r]);
        }
      }
      more |= found[r] < nsample[r];
    }
    if (!more) break;                                    // every radius full
  }

#pragma unroll
  for (int r = 0; r < NR; ++r) {
    for (int k = found[r] + lane; k < nsample[r]; k += 32) out[r][k] = first[r];
    if (lane == 0) rr.r[r].cnt[row] = found[r];
  }
}

template <int NR>
int launch(const float* xyz, const float* centres, const unsigned char* mask,
           const Radii<NR>& rr, int b, int n, int s, void* stream) {
  const dim3 grid((s + kWarps - 1) / kWarps, b);
  ball_query_kernel<NR><<<grid, kThreads, 0, (cudaStream_t)stream>>>(xyz, centres, mask, rr,
                                                                     n, s);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz (b, n, 3), centres (b, s, 3) f32; mask (b, n) bool; idx (b, s,
// nsample), cnt (b, s) int32 out. 1 <= nsample <= 128. Returns
// cudaGetLastError() after the launch.
extern "C" int hvpr_ball_query(const float* xyz, const float* centres,
                               const unsigned char* mask, int* idx, int* cnt,
                               float r2, int b, int n, int s, int nsample,
                               void* stream) {
  const Radii<1> rr{{{r2, nsample, idx, cnt}}};
  return launch(xyz, centres, mask, rr, b, n, s, stream);
}

// Both radii of an MSG level in one sweep: the outputs of two
// hvpr_ball_query calls on the same points and centres.
extern "C" int hvpr_ball_query2(const float* xyz, const float* centres,
                                const unsigned char* mask, int* idx0, int* cnt0,
                                float r2_0, int nsample0, int* idx1, int* cnt1, float r2_1,
                                int nsample1, int b, int n, int s, void* stream) {
  const Radii<2> rr{{{r2_0, nsample0, idx0, cnt0}, {r2_1, nsample1, idx1, cnt1}}};
  return launch(xyz, centres, mask, rr, b, n, s, stream);
}
