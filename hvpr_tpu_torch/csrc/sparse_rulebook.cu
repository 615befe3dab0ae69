// The rulebook of a sparse 3D convolution: every tap's neighbour lookup
// in one launch (K14).
//
// Replaces: no TPU kernel. hvpr_tpu/ops/sparse_conv.py looks the taps up
// with XLA, and the port's plain version (ops/sparse_conv.py, _tap_lookups)
// issues ~38 small torch ops a tap: the offset add, the bound tests, the
// linear id, searchsorted, the clamp, gather, compare and where, the
// spread rows. VoxelBackBone8x has 12 convs of up to 27 taps, so the host
// issued some 11,000 launches a forward for this alone.
//
// What it computes, bit for bit: for each query site (b, m) and tap t in
// the (dz, dy, dx) raster order of _offsets (centred: [-(k-1)/2, k/2] an
// axis; else [0, k) from the window origin), the neighbour q = coords +
// offset, ok = the query's validity and q inside the grid, its linear id
// z * ny * nx + y * nx + x, and its lower bound in the batch row's sorted
// ids (torch.searchsorted, side left); hit = ok and ids[lb] == id, pos =
// lb on a hit, else the spread row m % V (spread_rows). The plain
// version's clamp of lb to V - 1 changes no hit: lb = V means every id is
// smaller.
//
// What bounds it on the H100: the rulebook's bytes written, 9 T B M (8 for
// pos, 1 for hit: 69 MB at 27 taps of 4 x 80,000 sites, 0.02 ms at 3.35
// TB/s), with the ids (B V int64, 2.5 MB) and the coordinates read once.
// The searches add dependent L2 reads: the ids stay in the 50 MB L2.
//
// Design:
// - A thread a query site, the taps in raster order in a loop: it reads
//   its coordinates and validity once. The offsets come from the kernel
//   sizes and the centred flag; nothing else is copied to the device.
// - Neighbouring threads take neighbouring sites, so each tap's stores are
//   coalesced along M, one (B, M) plane a tap, and since the sites are
//   sorted a warp's searches probe neighbouring ids (the first steps are
//   broadcasts).
// - The taps of one (dz, dy) row probe consecutive ids. A binary search
//   finds the row's first in-grid tap; each next one starts from the last
//   lower bound and steps while the id there is smaller (at most one step
//   for unique ids). A 3 x 3 x 3 conv pays 9 binary searches a site, not
//   27.
// - No allocation, no host sync: the wrapper allocates pos and hit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// the first index of ids[0, n) whose value is >= q (n if none)
__device__ __forceinline__ int lower_bound(const long long* __restrict__ ids, int n,
                                           long long q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ids + mid) < q) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

template <typename Coord>
__global__ void sparse_rulebook_kernel(const long long* __restrict__ in_lin, int v,
                                       const Coord* __restrict__ coords,
                                       const bool* __restrict__ ok, int m, long long bm,
                                       int kz, int ky, int kx, int oz, int oy, int ox,
                                       int nz, int ny, int nx, long long* __restrict__ pos,
                                       bool* __restrict__ hit) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= bm) return;
  const long long row = i / m;
  const long long* ids = in_lin + row * v;
  const long long spread = (i - row * m) % v;
  const long long z = coords[3 * i], y = coords[3 * i + 1], x = coords[3 * i + 2];
  const bool valid = ok[i];
  const long long plane = static_cast<long long>(ny) * nx;
  long long t = 0;
  for (int dz = 0; dz < kz; ++dz) {
    const long long zz = z + dz - oz;
    for (int dy = 0; dy < ky; ++dy) {
      const long long yy = y + dy - oy;
      const bool row_ok = valid && zz >= 0 && zz < nz && yy >= 0 && yy < ny;
      const long long base = zz * plane + yy * nx;
      int lb = -1;                          // the last lower bound in this row
      for (int dx = 0; dx < kx; ++dx, ++t) {
        const long long xx = x + dx - ox;
        bool found = false;
        if (row_ok && xx >= 0 && xx < nx) {
          const long long q = base + xx;
          if (lb < 0) {
            lb = lower_bound(ids, v, q);
          } else {
            while (lb < v && __ldg(ids + lb) < q) ++lb;
          }
          found = lb < v && __ldg(ids + lb) == q;
        }
        pos[t * bm + i] = found ? static_cast<long long>(lb) : spread;
        hit[t * bm + i] = found;
      }
    }
  }
}

}  // namespace

// in_lin (b, v) int64: each row's sorted linear ids (the sentinel nz * ny *
// nx past its valid sites); coords (b, m, 3) zyx, int64 when coords_64 = 1,
// else int32; ok (b, m) bool; kernel (kz, ky, kx), centred = 1 for the
// submanifold offsets, 0 for the window origin's; grid (nz, ny, nx); pos
// (kz ky kx, b, m) int64 and hit (kz ky kx, b, m) bool, written whole.
// Returns cudaGetLastError() after the launch (none when b m is 0).
extern "C" int hvpr_sparse_rulebook(const long long* in_lin, int v, const void* coords,
                                    int coords_64, const void* ok, int b, int m, int kz,
                                    int ky, int kx, int centered, int nz, int ny, int nx,
                                    long long* pos, void* hit, void* stream) {
  const long long bm = static_cast<long long>(b) * m;
  if (bm <= 0) return static_cast<int>(cudaSuccess);
  if (v <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (bm + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int oz = centered ? (kz - 1) / 2 : 0, oy = centered ? (ky - 1) / 2 : 0,
            ox = centered ? (kx - 1) / 2 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool* okb = static_cast<const bool*>(ok);
  bool* hitb = static_cast<bool*>(hit);
  if (coords_64) {
    sparse_rulebook_kernel<long long><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        in_lin, v, static_cast<const long long*>(coords), okb, m, bm, kz, ky, kx, oz, oy, ox,
        nz, ny, nx, pos, hitb);
  } else {
    sparse_rulebook_kernel<int><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        in_lin, v, static_cast<const int*>(coords), okb, m, bm, kz, ky, kx, oz, oy, ox, nz,
        ny, nx, pos, hitb);
  }
  return static_cast<int>(cudaGetLastError());
}
