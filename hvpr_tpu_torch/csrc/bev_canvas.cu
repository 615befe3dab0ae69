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
// carried over. The wrapper zeroes the canvas; here one warp copies one valid
// pillar's row (already in the canvas dtype) to canvas[b, y * nx + x, :] in
// 16-byte vectors, neighbouring lanes on neighbouring addresses. Cells are
// unique per sample, so no two warps write the same bytes and the copy is
// exact in any dtype; rows of invalid pillars and cells outside the grid are
// skipped.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void bev_canvas_kernel(const uint4* __restrict__ feat,
                                  const int* __restrict__ coords,
                                  const bool* __restrict__ mask,
                                  uint4* __restrict__ canvas, int B, int V,
                                  int ny, int nx, int vec_per_row) {
  const long long pillar =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (pillar >= static_cast<long long>(B) * V || !mask[pillar]) return;
  const int y = coords[pillar * 3 + 1];
  const int x = coords[pillar * 3 + 2];
  if (y < 0 || y >= ny || x < 0 || x >= nx) return;
  const long long b = pillar / V;
  const long long cell = (b * ny + y) * nx + x;
  const uint4* src = feat + pillar * vec_per_row;
  uint4* dst = canvas + cell * vec_per_row;
  for (int i = lane; i < vec_per_row; i += 32) dst[i] = src[i];
}

}  // namespace

// feat (B, V, row) and canvas (B, ny, nx, row) in one dtype, rows of
// vec_per_row 16-byte vectors; coords (B, V, 3) int32 (z, y, x); mask (B, V)
// bool. The canvas must be zeroed. Returns cudaGetLastError() after launch.
extern "C" int hvpr_bev_canvas(const void* feat, const int* coords,
                               const void* mask, void* canvas, int B, int V,
                               int ny, int nx, int vec_per_row, void* stream) {
  const long long threads = static_cast<long long>(B) * V * 32;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  bev_canvas_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(feat), coords, static_cast<const bool*>(mask),
      static_cast<uint4*>(canvas), B, V, ny, nx, vec_per_row);
  return static_cast<int>(cudaGetLastError());
}
