// Dense BEV canvas from pillars with per-sample unique cells (K3).
//
// Replaces: hvpr_tpu/ops/bev_canvas.py, canvas_from_sorted (:63) and its
// Pallas body _kernel (:35), which fills each 256-cell canvas tile from a
// two-block window of cell-sorted pillars with a one-hot matmul on the MXU
// (split-bf16 for f32 exactness).
//
// What bounds it on the H100: memory, the canvas write. The canvas
// (B x ny x nx x C) is ~7x larger than the pillar rows it receives, so the
// bound is (canvas bytes + pillar bytes) / 3.35 TB/s.
//
// Design: the one-hot trick is a device of the TPU's matrix unit and is not
// carried over. The canvas is written exactly once, never zeroed in a pass
// of its own: a small kernel writes a (B, ny * nx) int32 map from each cell
// to the pillar that fills it (the map is set to -1 first; 4 bytes a cell
// against the canvas's 2 C or 4 C), then the canvas kernel gives one thread
// to every 16-byte vector of the canvas, neighbouring threads on
// neighbouring vectors: it writes zeros, or the matching vector of its
// cell's f32 pillar row cast to the canvas dtype (round to nearest even for
// bf16, as the plain version's cast). Cells are unique per sample, so the
// map has no write conflicts and the result is exact; invalid pillars and
// cells outside the grid leave their cell at -1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void cell_map_kernel(const int* __restrict__ coords,
                                const bool* __restrict__ mask,
                                int* __restrict__ cell_map, int B, int V, int ny,
                                int nx) {
  const long long pillar = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (pillar >= static_cast<long long>(B) * V || !mask[pillar]) return;
  const int y = coords[pillar * 3 + 1];
  const int x = coords[pillar * 3 + 2];
  if (y < 0 || y >= ny || x < 0 || x >= nx) return;
  const long long b = pillar / V;
  cell_map[(b * ny + y) * nx + x] = static_cast<int>(pillar - b * V);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// one thread per 16-byte vector of the canvas: 4 f32 or 8 bf16 channels;
// blockIdx.y is the sample, so indices within a sample stay 32-bit
template <bool kBf16>
__global__ void canvas_kernel(const float4* __restrict__ feat,
                              const int* __restrict__ cell_map,
                              uint4* __restrict__ canvas, int cells, int V,
                              int vec_per_row) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells * vec_per_row) return;
  const long long b = blockIdx.y;
  const int cell = i / vec_per_row;
  const int j = i - cell * vec_per_row;
  const int p = cell_map[b * cells + cell];
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (p >= 0) {
    const long long row = b * V + p;
    if (kBf16) {
      const float4* src = feat + (row * vec_per_row + j) * 2;   // 8 f32 a vector
      const float4 lo = src[0], hi = src[1];
      out = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                       pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
    } else {
      const float4 a = feat[row * vec_per_row + j];
      out = make_uint4(__float_as_uint(a.x), __float_as_uint(a.y),
                       __float_as_uint(a.z), __float_as_uint(a.w));
    }
  }
  canvas[b * cells * vec_per_row + i] = out;
}

}  // namespace

// feat (B, V, C) f32; coords (B, V, 3) int32 (z, y, x); mask (B, V) bool;
// cell_map (B, ny * nx) int32 scratch; canvas (B, ny, nx, C) f32 (bf16 = 0)
// or bf16 (bf16 = 1), rows of vec_per_row 16-byte vectors. Returns
// cudaGetLastError() after the launches.
extern "C" int hvpr_bev_canvas(const void* feat, const int* coords, const void* mask,
                               int* cell_map, void* canvas, int B, int V, int ny,
                               int nx, int vec_per_row, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(B) * ny * nx;
  cudaError_t err = cudaMemsetAsync(cell_map, 0xff, cells * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long pillars = static_cast<long long>(B) * V;
  if (pillars > 0) {
    cell_map_kernel<<<static_cast<int>((pillars + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        coords, static_cast<const bool*>(mask), cell_map, B, V, ny, nx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_sample = ny * nx * vec_per_row;
  if (B == 0 || per_sample == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((per_sample + kThreads - 1) / kThreads, B);
  if (bf16) {
    canvas_kernel<true><<<grid, kThreads, 0, s>>>(static_cast<const float4*>(feat), cell_map,
                                                  static_cast<uint4*>(canvas), ny * nx, V,
                                                  vec_per_row);
  } else {
    canvas_kernel<false><<<grid, kThreads, 0, s>>>(static_cast<const float4*>(feat), cell_map,
                                                   static_cast<uint4*>(canvas), ny * nx, V,
                                                   vec_per_row);
  }
  return static_cast<int>(cudaGetLastError());
}
