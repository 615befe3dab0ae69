// The first design of K11, csrc/three_nn.cu, as it was before its Hopper redesign,
// kept so that chip_smoke.py (ms_before_redesign) and
// tools/torch_port/k11_k12_versions.py time it beside the current one.
//
// Bucketed 3-NN (kernel K11), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel hvpr_tpu/ops/pn2_select.py:135 (`_bucket_sweep`,
// mode 'nn', called by `three_nn_bucket` :231), which streams the known
// points once per block of unknown points, keeps a 128-lane running minimum
// of the squared distance per bucket (known index mod 128) with the index
// that reaches it, and leaves the top 3 of the 128 bucket minima to XLA.
//
// Here a warp owns kPerWarp unknown points and each lane four buckets,
// lane + 32 j for j < 4; the known points of the batch element stream
// through shared memory in tiles of kTile points, a multiple of 128, so
// point base + lane + 32 j of a tile always falls in the lane's bucket j.
// Points are visited in index order and a bucket updates on a strictly
// smaller key, so it keeps the lowest index among equal keys, and a bucket
// that never sees a valid point keeps its initial key 1e30 and index 0, as
// the TPU sweep does (a masked point's key there is d2 + 1e30 = 1e30 in f32,
// which never updates). The top 3 then come from three warp-wide argmin
// rounds over (key, bucket), ties to the lower bucket as in `lax.top_k`.
//
// Bound: operations on the CUDA cores, ~10 f32 operations per
// (unknown, known) pair (3 sub, 3 mul, 2 add, compare, select), at 67
// TFLOP/s f32; the inputs and outputs are under a megabyte at hvpr.yaml's
// shapes. Each lane reads a known point from shared memory once for the
// warp's kPerWarp unknown points.
//
// Exactness: the squared distance is ((dx*dx + dy*dy) + dz*dz) with every
// product and sum rounded on its own (__fmul_rn/__fadd_rn: no FMA
// contraction), the plain version's order, so ties and near-ties select
// the same points in both.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = 4;               // unknown points per warp
constexpr int kPerBlock = kWarps * kPerWarp;
constexpr int kTile = 1024;               // known points per shared tile
constexpr int kSlots = 4;                 // buckets per lane (128 / 32)
constexpr float kBig = 1e30f;
constexpr float kInf = 1e10f;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az, float bx,
                                         float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads)
three_nn_kernel(const float* __restrict__ unknown, const float* __restrict__ known,
                const unsigned char* __restrict__ mask, float* __restrict__ dist,
                int* __restrict__ idx, int n, int s) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile];
  __shared__ unsigned char sv[kTile];

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kPerBlock + warp * kPerWarp;
  const float* pts = known + (size_t)b * s * 3;
  const unsigned char* valid = mask + (size_t)b * s;

  float ux[kPerWarp], uy[kPerWarp], uz[kPerWarp];
  float key[kPerWarp][kSlots];
  int arg[kPerWarp][kSlots];
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    const int q = min(q0 + u, n - 1);
    const float* p = unknown + ((size_t)b * n + q) * 3;
    ux[u] = p[0];
    uy[u] = p[1];
    uz[u] = p[2];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      key[u][j] = kBig;
      arg[u][j] = 0;
    }
  }

  for (int base = 0; base < s; base += kTile) {
    const int len = min(kTile, s - base);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) {
      sx[i] = pts[(size_t)(base + i) * 3 + 0];
      sy[i] = pts[(size_t)(base + i) * 3 + 1];
      sz[i] = pts[(size_t)(base + i) * 3 + 2];
      sv[i] = valid[base + i];
    }
    __syncthreads();
    for (int t = 0; t < len; t += 32 * kSlots) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int i = t + lane + 32 * j;
        if (i < len && sv[i]) {
          const float px = sx[i], py = sy[i], pz = sz[i];
#pragma unroll
          for (int u = 0; u < kPerWarp; ++u) {
            const float d2 = sq_dist(ux[u], uy[u], uz[u], px, py, pz);
            if (d2 < key[u][j]) {
              key[u][j] = d2;
              arg[u][j] = base + i;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    const int q = q0 + u;
    unsigned taken = 0u;
    float out_d[3];
    int out_i[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      // this lane's least untaken bucket, then the warp's (key, bucket) argmin
      float bk = INFINITY;
      int bj = 0, bi = 0;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (!((taken >> j) & 1u) && key[u][j] < bk) {
          bk = key[u][j];
          bj = j;
          bi = arg[u][j];
        }
      }
      float wk = bk;
      int wb = lane + 32 * bj;
      for (int off = 16; off > 0; off >>= 1) {
        const float ok = __shfl_xor_sync(0xffffffffu, wk, off);
        const int ob = __shfl_xor_sync(0xffffffffu, wb, off);
        if (ok < wk || (ok == wk && ob < wb)) {
          wk = ok;
          wb = ob;
        }
      }
      const int wi = __shfl_sync(0xffffffffu, bi, wb & 31);
      if ((wb & 31) == lane) taken |= 1u << (wb >> 5);
      out_d[r] = __fsqrt_rn(fmaxf(fminf(wk, kInf), 0.f));
      out_i[r] = min(max(wi, 0), s - 1);
    }
    if (lane == 0 && q < n) {
      const size_t o = ((size_t)b * n + q) * 3;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        dist[o + r] = out_d[r];
        idx[o + r] = out_i[r];
      }
    }
  }
}

}  // namespace

// unknown (B, N, 3) f32, known (B, S, 3) f32, mask (B, S) bool; dist and idx
// (B, N, 3) f32 / int32. Returns cudaGetLastError() after the launch.
extern "C" int hvpr_three_nn(const float* unknown, const float* known,
                             const unsigned char* mask, float* dist, int* idx,
                             int b, int n, int s, void* stream) {
  dim3 grid((n + kPerBlock - 1) / kPerBlock, b);
  three_nn_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(unknown, known, mask,
                                                               dist, idx, n, s);
  return (int)cudaGetLastError();
}
