// Bucketed 3-NN (kernel K11), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel hvpr_tpu/ops/pn2_select.py:135 (`_bucket_sweep`,
// mode 'nn', called by `three_nn_bucket` :231), which streams the known
// points once per block of unknown points, keeps a 128-lane running minimum
// of the squared distance per bucket (known index mod 128) with the index
// that reaches it, and leaves the top 3 of the 128 bucket minima to XLA.
//
// Here a first pass packs each known point once as a float4 (x, y, z, 0),
// a masked point and the padding up to a whole tile at +inf: such a point's
// key is inf, which never beats the initial 1e30, so it never lowers a
// bucket, as the TPU sweep's masked key d2 + 1e30 never does, and the sweep
// needs neither a mask test nor a bounds test. A warp owns kPerWarp unknown
// points and each lane four buckets, lane + 32 j for j < 4; the known points
// of the batch element stream through shared memory in tiles of kTile
// points, a multiple of 128, so point base + lane + 32 j of a tile always
// falls in the lane's bucket j, each tile copied by cp.async while the block
// sweeps the one before (two buffers). A lane reads a known point with one
// 16-byte shared load for the warp's kPerWarp unknown points, and keeps only
// each bucket's least key (one min a pair). The top 3 then come from three
// warp-wide argmin rounds over (key, bucket), ties to the lower bucket as
// in `lax.top_k`; each winner's index is the lowest one in its bucket whose
// key equals the minimum, found by sweeping that bucket's points again, 32
// at a time: the first index to reach the minimum, which is what the TPU
// sweep keeps (points in index order, an update only on a strictly smaller
// key); a bucket that never saw a valid point keeps key 1e30 and index 0.

// Bound: operations on the CUDA cores, ~10 f32 operations per
// (unknown, known) pair (3 sub, 3 mul, 2 add, compare, select), at 67
// TFLOP/s f32; without FMA each is an instruction of its own, so the issue
// floor is about twice the bound (9 instructions a pair here: the min
// stands for the compare and select). The inputs and outputs are under a
// megabyte at hvpr.yaml's shapes.
//
// Exactness: the squared distance is ((dx*dx + dy*dy) + dz*dz) with every
// product and sum rounded on its own (__fmul_rn/__fadd_rn: no FMA
// contraction), the plain version's order, so ties and near-ties select
// the same points in both.

#include <cuda_runtime.h>
#include <math.h>

#include "dmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = 8;               // unknown points per warp
constexpr int kPerBlock = kWarps * kPerWarp;
constexpr int kTile = 1024;               // known points per shared tile
constexpr int kSlots = 4;                 // buckets per lane (128 / 32)
constexpr int kMinBlocks = 2;             // blocks an SM: at most 128 registers
constexpr float kBig = 1e30f;
constexpr float kInf = 1e10f;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az, float bx,
                                         float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__global__ void pack_kernel(const float* __restrict__ known,
                            const unsigned char* __restrict__ mask, float4* __restrict__ packed,
                            int s, int s_pad, long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const long long b = i / s_pad;
    const int p = (int)(i - b * s_pad);
    const long long k = b * s + p;
    packed[i] = p < s && mask[k]
                    ? make_float4(known[3 * k], known[3 * k + 1], known[3 * k + 2], 0.f)
                    : make_float4(INFINITY, INFINITY, INFINITY, 0.f);
  }
}

// start copying a tile of packed points from src into dst, 16 bytes a copy
__device__ __forceinline__ void stage_tile(const float4* __restrict__ src, float4* dst) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst + i);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(saddr), "l"(src + i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
three_nn_kernel(const float* __restrict__ unknown, const float4* __restrict__ packed,
                float* __restrict__ dist, int* __restrict__ idx, int n, int s, int s_pad) {
  __shared__ float4 tile[2][kTile];

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kPerBlock + warp * kPerWarp;
  const float4* pts = packed + (size_t)b * s_pad;

  float ux[kPerWarp], uy[kPerWarp], uz[kPerWarp];
  float key[kPerWarp][kSlots];
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    const int q = min(q0 + u, n - 1);
    const float* p = unknown + ((size_t)b * n + q) * 3;
    ux[u] = p[0];
    uy[u] = p[1];
    uz[u] = p[2];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) key[u][j] = kBig;
  }

  const int tiles = s_pad / kTile;
  if (tiles > 0) stage_tile(pts, tile[0]);
  for (int k = 0; k < tiles; ++k) {
    if (k + 1 < tiles) {
      stage_tile(pts + (size_t)(k + 1) * kTile, tile[(k + 1) & 1]);
      hvpr::cp_async_wait<1>();
    } else {
      hvpr::cp_async_wait<0>();
    }
    __syncthreads();
    const float4* tp = tile[k & 1];
    for (int t = 0; t < kTile; t += 32 * kSlots) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int i = t + lane + 32 * j;
        const float4 p = tp[i];
#pragma unroll
        for (int u = 0; u < kPerWarp; ++u) {
          key[u][j] = fminf(key[u][j], sq_dist(ux[u], uy[u], uz[u], p.x, p.y, p.z));
        }
      }
    }
    __syncthreads();
  }

  // each unknown point's 3 least (key, bucket), and the index that reaches
  // each key first
  float wk[kPerWarp][3];
  int wb[kPerWarp][3], wi[kPerWarp][3];
#pragma unroll
  for (int u = 0; u < kPerWarp; ++u) {
    unsigned taken = 0u;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      // this lane's least untaken bucket, then the warp's (key, bucket) argmin
      float bk = INFINITY;
      int bj = 0;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        if (!((taken >> j) & 1u) && key[u][j] < bk) {
          bk = key[u][j];
          bj = j;
        }
      }
      float k = bk;
      int bucket = lane + 32 * bj;
      for (int off = 16; off > 0; off >>= 1) {
        const float ok = __shfl_xor_sync(0xffffffffu, k, off);
        const int ob = __shfl_xor_sync(0xffffffffu, bucket, off);
        if (ok < k || (ok == k && ob < bucket)) {
          k = ok;
          bucket = ob;
        }
      }
      if ((bucket & 31) == lane) taken |= 1u << (bucket >> 5);
      wk[u][r] = k;
      wb[u][r] = bucket;
      wi[u][r] = k < kBig ? -1 : 0;
    }
  }
  // the sweep kept each bucket's least key only: its lowest index with
  // that key is the first to reach it (a bucket at 1e30 saw no valid
  // point: index 0). The bucket's points again, 32 at a time, a lane each,
  // the same arithmetic, so the same bits
  const int rows = s_pad / 128;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    for (int m0 = 0; m0 < rows; m0 += 32) {
      float4 p[kPerWarp];
#pragma unroll
      for (int u = 0; u < kPerWarp; ++u) {
        p[u] = wi[u][r] < 0 && m0 + lane < rows
                   ? __ldg(pts + wb[u][r] + 128 * (m0 + lane))
                   : make_float4(INFINITY, INFINITY, INFINITY, 0.f);
      }
      bool more = false;
#pragma unroll
      for (int u = 0; u < kPerWarp; ++u) {
        if (wi[u][r] < 0) {
          const unsigned hit = __ballot_sync(
              0xffffffffu, sq_dist(ux[u], uy[u], uz[u], p[u].x, p[u].y, p[u].z) == wk[u][r]);
          if (hit) {
            wi[u][r] = wb[u][r] + 128 * (m0 + __ffs(hit) - 1);
          } else {
            more = true;
          }
        }
      }
      if (!more) break;
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int u = 0; u < kPerWarp; ++u) {
      const int q = q0 + u;
      if (q < n) {
        const size_t o = ((size_t)b * n + q) * 3;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          dist[o + r] = __fsqrt_rn(fmaxf(fminf(wk[u][r], kInf), 0.f));
          idx[o + r] = min(max(wi[u][r], 0), s - 1);
        }
      }
    }
  }
}

}  // namespace

// unknown (B, N, 3) f32, known (B, S, 3) f32, mask (B, S) bool; packed
// (B, hvpr_three_nn_padded(S), 4) f32 scratch; dist and idx (B, N, 3) f32 /
// int32. Returns cudaGetLastError() after the launches.
extern "C" int hvpr_three_nn_padded(int s) { return (s + kTile - 1) / kTile * kTile; }

extern "C" int hvpr_three_nn(const float* unknown, const float* known,
                             const unsigned char* mask, float* packed, float* dist, int* idx,
                             int b, int n, int s, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int s_pad = hvpr_three_nn_padded(s);
  const long long total = (long long)b * s_pad;
  if (total > 0) {
    pack_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        known, mask, reinterpret_cast<float4*>(packed), s, s_pad, total);
  }
  dim3 grid((n + kPerBlock - 1) / kPerBlock, b);
  three_nn_kernel<<<grid, kThreads, 0, st>>>(unknown, reinterpret_cast<const float4*>(packed),
                                             dist, idx, n, s, s_pad);
  return (int)cudaGetLastError();
}
