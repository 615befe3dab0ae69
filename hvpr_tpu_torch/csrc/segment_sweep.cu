// Per-row full-segment max / sum over channel-major flat pillar rows (K1).
//
// Replaces: hvpr_tpu/ops/segment_sweep.py, segment_sweep_pallas (:74) and its
// Pallas body _kernel (:56), which runs log2(max_seg) masked doubling shifts
// forward and backward over a VMEM row block with a +-max_seg halo.
//
// What bounds it on the H100: memory. Each call reads x (C x R f32) and the
// slots once and writes C x R f32 once, a few operations per byte, so the
// bound is bytes / 3.35 TB/s.
//
// What it computes, bit for bit: the plain version's masked doubling sweeps
// (ops/scatter.py), d = 1, 2, 4, ... < max_seg. A forward step gives row j
// combine(y[j], slot[j - d] == slot[j] ? y[j - d] : neutral) where j - d
// lies in [0, R), and leaves y[j] as it is where it does not; the reverse
// step mirrors it with j + d. max: forward running max, then the reverse
// sweep of it (NaN-propagating, as torch.maximum on the card). sum:
// (inclusive prefix + inclusive suffix) - self. Every combine happens in
// the plain version's order, so the sum is bit-identical, not only close;
// max keeps the doubling order as well (fmaxf in another order could move
// the sign of a zero).
//
// Design (channels in parallel, no block barrier per doubling step):
// - A block owns a window of kWin = 512 consecutive rows and a group of up
//   to 8 channels, one warp a channel; the grid's second axis walks the
//   channel groups. There is no loop over channels: each warp holds one
//   (channel, window) piece.
// - The window's rows are its kOut output rows plus a halo of H rows on
//   each side, H = the doubling's reach (2^steps - 1) rounded up to 4, so
//   every output row's sweeps stay inside the window (the halo rows come
//   out wrong and are not written).
// - The slots are staged once a block: each row's 4 bits a step (the
//   forward and reverse slot match, and whether j - d and j + d lie in
//   [0, R)) are packed into one word in shared memory that every warp of
//   the block reads. Two block barriers a block, none a step.
// - Each lane holds 16 consecutive rows of its channel in registers (four
//   16-byte loads). A doubling step by d = 16a + b takes rows from its own
//   registers and from lane - a (or - a - 1) with one __shfl_sync a moved
//   value: d shuffles a step below d = 16, 16 from there. The warp runs
//   both sweeps warp-synchronously.
// - One read and one write of each channel row: 16-byte loads and stores
//   where R % 4 == 0 and the pointers are 16-byte aligned, scalar ones at
//   the array's ends and otherwise, all inside the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPer = 16;                // consecutive rows a lane holds
constexpr int kWin = 32 * kPer;         // rows a window (a warp's strip)
constexpr int kMaxWarps = 8;            // channels a block
constexpr int kPad = 32;                // staged slots beyond the window: max d
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum on the card: fmaxf, and NaN if either side is NaN (the
// canonical NaN here, torch's the NaN it was given: bits that differ only
// where no two NaNs compare equal anyway)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The 16 rows d rows before (kRev: after) each of this lane's rows, from this
// lane and the lanes below (above). Rows that fall outside the window wrap
// around the warp and come out as garbage; only halo rows read them.
template <int D, bool kRev>
__device__ __forceinline__ void shifted(const float (&v)[kPer], float (&src)[kPer], int lane) {
  constexpr int a = D / kPer, b = D % kPer;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (!kRev) {
      if (e >= b) {
        src[e] = a == 0 ? v[e - b] : __shfl_sync(kFull, v[e - b], (lane - a) & 31);
      } else {
        src[e] = __shfl_sync(kFull, v[e - b + kPer], (lane - a - 1) & 31);
      }
    } else {
      if (e + b < kPer) {
        src[e] = a == 0 ? v[e + b] : __shfl_sync(kFull, v[e + b], (lane + a) & 31);
      } else {
        src[e] = __shfl_sync(kFull, v[e + b - kPer], (lane + a + 1) & 31);
      }
    }
  }
}

// One masked doubling sweep of the lane's 16 rows, steps 0 .. NS-1. Mask
// word bits: s forward match, 8 + s forward source in [0, R), 16 + s
// reverse match, 24 + s reverse source in [0, R). Away from the array's
// ends (kEdge false) every source lies in [0, R) and the second test goes.
template <int NS, bool kMax, bool kRev, bool kEdge>
__device__ __forceinline__ void sweep(float (&v)[kPer], const unsigned (&mask)[kPer], int lane) {
  constexpr float kNeutral = kMax ? -1e9f : 0.0f;
  constexpr int kSame = kRev ? 16 : 0, kIn = kRev ? 24 : 8;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    float src[kPer];
    // s is a compile-time constant once unrolled; dispatch the shift width
    switch (s) {
      case 0: shifted<1, kRev>(v, src, lane); break;
      case 1: shifted<2, kRev>(v, src, lane); break;
      case 2: shifted<4, kRev>(v, src, lane); break;
      case 3: shifted<8, kRev>(v, src, lane); break;
      case 4: shifted<16, kRev>(v, src, lane); break;
      default: shifted<32, kRev>(v, src, lane); break;
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const float o = (mask[e] >> (kSame + s)) & 1u ? src[e] : kNeutral;
      if (!kEdge || ((mask[e] >> (kIn + s)) & 1u)) v[e] = kMax ? max_nan(v[e], o) : v[e] + o;
    }
  }
}

// The lane's 16 rows of its channel, zero outside [0, R) (kEdge: the
// window reaches past an end of the array).
template <bool kEdge>
__device__ __forceinline__ void load_rows(const float* __restrict__ xc, float (&v)[kPer],
                                          int ws, int R, int vec) {
  const int r0 = ws + (threadIdx.x & 31) * kPer;    // this lane's first row
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    const int g = r0 + 4 * q;
    if (vec && (!kEdge || (g >= 0 && g + 4 <= R))) {
      const float4 t = *reinterpret_cast<const float4*>(xc + g);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[4 * q + e] = (g + e >= 0 && g + e < R) ? xc[g + e] : 0.0f;
    }
  }
}

// Run the sweeps on the lane's rows v and store the rows of the window's
// output part.
template <int NS, bool kMax, bool kEdge>
__device__ __forceinline__ void sweep_rows(const float (&v)[kPer], float* __restrict__ oc,
                                           const unsigned* s_mask, int ws, int R, int vec) {
  constexpr int kHalo = (((1 << NS) - 1) + 3) & ~3;
  const int lane = threadIdx.x & 31;
  unsigned mask[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) mask[e] = s_mask[lane * (kPer + 1) + e];

  float y[kPer];
  if (kMax) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) y[e] = v[e];
    sweep<NS, true, false, kEdge>(y, mask, lane);
    sweep<NS, true, true, kEdge>(y, mask, lane);
  } else {
    float f[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) f[e] = y[e] = v[e];
    sweep<NS, false, false, kEdge>(f, mask, lane);
    sweep<NS, false, true, kEdge>(y, mask, lane);
#pragma unroll
    for (int e = 0; e < kPer; ++e) y[e] = (f[e] + y[e]) - v[e];
  }

  // this window's output rows [ws + kHalo, ws + kWin - kHalo): whole groups of 4
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    const int w = lane * kPer + 4 * q, g = ws + w;
    if (w < kHalo || w >= kWin - kHalo) continue;
    if (vec && (!kEdge || g + 4 <= R)) {
      *reinterpret_cast<float4*>(oc + g) =
          make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (g + e < R) oc[g + e] = y[4 * q + e];
    }
  }
}

template <int NS, bool kMax>
__global__ void __launch_bounds__(kMaxWarps * 32)
segment_sweep_kernel(const float* __restrict__ x, const int* __restrict__ slot,
                     float* __restrict__ out, int C, int R, int vec) {
  constexpr int kReach = (1 << NS) - 1;
  constexpr int kHalo = (kReach + 3) & ~3;
  constexpr int kOut = kWin - 2 * kHalo;
  __shared__ int s_slot[kWin + 2 * kPad];
  __shared__ unsigned s_mask[kWin + kWin / kPer];   // one pad word every 16: no bank conflicts

  const int ws = blockIdx.x * kOut - kHalo;         // the window's first row
  // a window whose sweeps reach past neither end of the array skips the
  // range tests (uniform across the block)
  const bool edge = ws - kPad < 0 || ws + kWin + kPad > R;
  for (int j = threadIdx.x; j < kWin + 2 * kPad; j += blockDim.x) {
    const int g = ws - kPad + j;
    s_slot[j] = (g >= 0 && g < R) ? slot[g] : -1;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < kWin; w += blockDim.x) {
    const int g = ws + w, me = s_slot[w + kPad];
    unsigned m = 0;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int d = 1 << s;
      m |= unsigned(s_slot[w + kPad - d] == me) << s;
      m |= unsigned(g - d >= 0) << (8 + s);
      m |= unsigned(s_slot[w + kPad + d] == me) << (16 + s);
      m |= unsigned(g + d < R) << (24 + s);
    }
    s_mask[w + w / kPer] = m;
  }
  __syncthreads();

  const int c = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c >= C) return;
  const float* xc = x + static_cast<long long>(c) * R;
  float* oc = out + static_cast<long long>(c) * R;
  float v[kPer];
  if (edge) {
    load_rows<true>(xc, v, ws, R, vec);
    sweep_rows<NS, kMax, true>(v, oc, s_mask, ws, R, vec);
  } else {
    load_rows<false>(xc, v, ws, R, vec);
    sweep_rows<NS, kMax, false>(v, oc, s_mask, ws, R, vec);
  }
}

template <int NS>
int launch(const float* x, const int* slot, float* out, int C, int R, int op,
           cudaStream_t s) {
  constexpr int kHalo = (((1 << NS) - 1) + 3) & ~3;
  constexpr int kOut = kWin - 2 * kHalo;
  const int warps = C < kMaxWarps ? C : kMaxWarps;
  const dim3 grid((R + kOut - 1) / kOut, (C + warps - 1) / warps);
  const int vec = R % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (op == 0) {
    segment_sweep_kernel<NS, true><<<grid, warps * 32, 0, s>>>(x, slot, out, C, R, vec);
  } else {
    segment_sweep_kernel<NS, false><<<grid, warps * 32, 0, s>>>(x, slot, out, C, R, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (C, R) f32 contiguous; slot: (R,) int32; max_seg in [1, 64].
// op 0 = max, 1 = sum. Returns cudaGetLastError() after the launch.
extern "C" int hvpr_segment_sweep(const float* x, const int* slot, float* out,
                                  int C, int R, int max_seg, int op,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int steps = 0;                                   // d = 1, 2, 4, ... < max_seg
  while ((1 << steps) < max_seg) ++steps;
  switch (steps) {
    case 0: return launch<0>(x, slot, out, C, R, op, s);
    case 1: return launch<1>(x, slot, out, C, R, op, s);
    case 2: return launch<2>(x, slot, out, C, R, op, s);
    case 3: return launch<3>(x, slot, out, C, R, op, s);
    case 4: return launch<4>(x, slot, out, C, R, op, s);
    case 5: return launch<5>(x, slot, out, C, R, op, s);
    case 6: return launch<6>(x, slot, out, C, R, op, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
