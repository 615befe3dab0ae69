// Per-row full-segment max / sum over channel-major flat pillar rows (K1).
//
// Replaces: hvpr_tpu/ops/segment_sweep.py, segment_sweep_pallas (:74) and its
// Pallas body _kernel (:56), which runs log2(max_seg) masked doubling shifts
// forward and backward over a VMEM row block with a +-max_seg halo.
//
// What bounds it on the H100: memory. Each call reads x (C x R f32) and the
// slots once and writes C x R f32 once, a few flops per byte, so the bound is
// bytes / 3.35 TB/s.
//
// Design: one block owns a tile of kTile consecutive rows and stages their
// slots plus a halo of max_seg - 1 rows on each side in shared memory. It
// then walks the channels: for each it stages the x tile and halo with
// coalesced loads and runs the same masked doubling sweeps as the plain
// version (ops/scatter.py) in shared memory -- a forward running max (or
// inclusive prefix sum) and a reverse one, d = 1, 2, 4, ... < max_seg, one
// barrier per step. The halo is what the sweeps reach, so every tile row is
// exact, and because each addition happens in the plain version's order the
// sum is bit-identical to it, not only close. The row block is read from
// device memory once per channel (halo re-reads add 2 * halo / kTile) and
// the output is written once. Rows outside [0, R) carry slot -1, which never
// equals a real slot (slots are >= 0), as the plain version's edges do.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // rows per block == threads per block

// One masked doubling sweep of `y` (width entries) into itself, using `tmp`.
template <bool kMax>
__device__ void sweep(float* y, float* tmp, const int* s_slot, int width,
                      int max_seg, bool reverse) {
  for (int d = 1; d < max_seg; d *= 2) {
    for (int j = threadIdx.x; j < width; j += blockDim.x) {
      const int src = reverse ? j + d : j - d;
      float v = y[j];
      if (src >= 0 && src < width && s_slot[src] == s_slot[j]) {
        v = kMax ? fmaxf(v, y[src]) : v + y[src];
      }
      tmp[j] = v;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < width; j += blockDim.x) y[j] = tmp[j];
    __syncthreads();
  }
}

template <bool kMax>
__global__ void segment_sweep_kernel(const float* __restrict__ x,
                                     const int* __restrict__ slot,
                                     float* __restrict__ out, int C, int R,
                                     int max_seg) {
  extern __shared__ int smem[];
  const int halo = max_seg - 1;
  const int width = kTile + 2 * halo;
  int* s_slot = smem;
  float* s_x = reinterpret_cast<float*>(smem + width);
  float* s_a = s_x + width;
  float* s_b = s_a + width;
  float* s_tmp = s_b + width;

  const int r0 = blockIdx.x * kTile;
  const int base = r0 - halo;
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    const int r = base + j;
    s_slot[j] = (r >= 0 && r < R) ? slot[r] : -1;
  }

  for (int c = 0; c < C; ++c) {
    const float* xc = x + static_cast<long long>(c) * R;
    for (int j = threadIdx.x; j < width; j += blockDim.x) {
      const int r = base + j;
      const float v = (r >= 0 && r < R) ? xc[r] : 0.0f;
      s_x[j] = v;
      s_a[j] = v;
      if (!kMax) s_b[j] = v;
    }
    __syncthreads();
    // max: forward running max, then the reverse sweep of it.
    // sum: inclusive prefix + inclusive suffix - self.
    sweep<kMax>(s_a, s_tmp, s_slot, width, max_seg, false);
    if (kMax) {
      sweep<kMax>(s_a, s_tmp, s_slot, width, max_seg, true);
    } else {
      sweep<kMax>(s_b, s_tmp, s_slot, width, max_seg, true);
    }
    const int j = threadIdx.x + halo;
    const int row = r0 + threadIdx.x;
    if (row < R) {
      out[static_cast<long long>(c) * R + row] =
          kMax ? s_a[j] : (s_a[j] + s_b[j]) - s_x[j];
    }
    __syncthreads();
  }
}

}  // namespace

// x, out: (C, R) f32 contiguous; slot: (R,) int32. op 0 = max, 1 = sum.
// Returns cudaGetLastError() after the launch.
extern "C" int hvpr_segment_sweep(const float* x, const int* slot, float* out,
                                  int C, int R, int max_seg, int op,
                                  void* stream) {
  const int width = kTile + 2 * (max_seg - 1);
  const int blocks = (R + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>(width) * (sizeof(int) + 4 * sizeof(float));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == 0) {
    segment_sweep_kernel<true><<<blocks, kTile, smem, s>>>(x, slot, out, C, R,
                                                           max_seg);
  } else {
    segment_sweep_kernel<false><<<blocks, kTile, smem, s>>>(x, slot, out, C, R,
                                                            max_seg);
  }
  return static_cast<int>(cudaGetLastError());
}
