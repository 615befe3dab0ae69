// Exact furthest point sampling inside each of R point sets (kernel K5),
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel hvpr_tpu/ops/pn2_select.py:302
// (`fps_chunks_pallas` / `_fps_kernel` :251), which runs exact FPS inside
// each Morton chunk with all (batch x chunk) sets on the 128 lanes at once
// and every operand resident in VMEM.
//
// Two paths, both one block a point set. Each of the `nsamp` steps updates
// the minimum distance of every row against the last sample, then runs a
// block argmax (largest distance, ties to the lowest row: the plain
// version's `min(where(mind == max, rows, L-1))`), then broadcasts the
// winner through shared memory.
// - fps_kernel, a set of L <= 8192 rows (the Morton chunks of FPS_CHUNKS >
//   1): 256 threads; the points and their running minima live in shared
//   memory for the whole loop.
// - fps_long_kernel, a longer set (exact FPS over a whole scan, FPS_CHUNKS
//   1: 16,384 points at hvpr.yaml): 1024 threads; the first kLongHead =
//   16,384 rows keep their coordinates in shared memory (192 KB) and their
//   running minima in registers, 16 a thread (row t + 1024 k is thread t's
//   k-th). Rows past the head stream their coordinates from device memory
//   (L2) every step, with their minima in a scratch array there, so any L
//   that fits device memory runs. Why one block and not a cluster of
//   blocks sharing the argmax over DSMEM: a step is one link of a chain,
//   and a cluster would add a cluster-wide barrier to each step's two block
//   barriers while it cut the ~16 rows a thread that a step computes; one
//   block keeps the whole head on one SM, where no set waits on another.
//
// Bound: the steps are a chain, each waiting for the previous argmax, and
// there are only R blocks (64 at hvpr.yaml's chunked shapes, 4 for exact
// FPS at batch 4), so the latency of one step (2 block barriers and two
// shuffle trees) times `nsamp` bounds it, far above both its operation
// bound (~10 f32 operations per row and step at 67 TFLOP/s) and its byte
// bound.
//
// Exactness: squared distances are ((dx*dx + dy*dy) + dz*dz) with every
// product and sum rounded on its own (__fmul_rn/__fadd_rn: no FMA
// contraction), the plain version's order, so near-ties resolve the same.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLongThreads = 1024;                    // fps_long_kernel
constexpr int kLongWarps = kLongThreads / 32;
constexpr int kLongPer = 16;                          // minima a thread holds
constexpr int kLongHead = kLongThreads * kLongPer;    // rows held on chip
constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kLongWarps == 32, "warp 0 reduces one value a warp");

// (dx*dx + dy*dy) + dz*dz, every operation rounded on its own
__device__ __forceinline__ float sq_dist(float x, float y, float z, float lx, float ly,
                                         float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ void better(float& v, int& r, float ov, int orow) {
  if (ov > v || (ov == v && orow < r)) {
    v = ov;
    r = orow;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
           int* __restrict__ out, int l, int nsamp) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + l;
  float* sz = sy + l;
  float* mind = sz + l;
  __shared__ float warp_val[kWarps];
  __shared__ int warp_row[kWarps];
  __shared__ int s_last;

  const int set = blockIdx.x;
  const float* p = pts + (size_t)set * l * 3;
  const unsigned char* v = valid + (size_t)set * l;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // load, init the running minima, find the first valid row (else l - 1)
  int first = l - 1;
  for (int j = threadIdx.x; j < l; j += kThreads) {
    sx[j] = p[(size_t)j * 3 + 0];
    sy[j] = p[(size_t)j * 3 + 1];
    sz[j] = p[(size_t)j * 3 + 2];
    const bool ok = v[j] != 0;
    mind[j] = ok ? kBig : -kBig;
    if (ok) first = min(first, j);
  }
  for (int off = 16; off > 0; off >>= 1)
    first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
  if (lane == 0) warp_row[warp] = first;
  __syncthreads();
  if (threadIdx.x == 0) {
    int f = l - 1;
    for (int w = 0; w < kWarps; ++w) f = min(f, warp_row[w]);
    s_last = f;
  }
  __syncthreads();
  int last = s_last;

  int* o = out + (size_t)set * nsamp;
  for (int i = 0; i < nsamp; ++i) {
    if (threadIdx.x == 0) o[i] = last;
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float bv = -INFINITY;
    int br = l;
    for (int j = threadIdx.x; j < l; j += kThreads) {
      const float m = fminf(mind[j], sq_dist(sx[j], sy[j], sz[j], lx, ly, lz));
      mind[j] = m;
      if (m > bv) {            // rows rise within a thread: ties keep the first
        bv = m;
        br = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int orow = __shfl_xor_sync(0xffffffffu, br, off);
      better(bv, br, ov, orow);
    }
    if (lane == 0) {
      warp_val[warp] = bv;
      warp_row[warp] = br;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float fv = warp_val[0];
      int fr = warp_row[0];
      for (int w = 1; w < kWarps; ++w) better(fv, fr, warp_val[w], warp_row[w]);
      s_last = fr;
    }
    __syncthreads();
    last = s_last;
  }
}

// the largest (value, row) of the block, ties to the lower row, in every
// thread; (v, r) is the calling thread's own. Two block barriers.
__device__ __forceinline__ int long_argmax(float v, int r, float* warp_val, int* warp_row,
                                           int* s_row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    better(v, r, __shfl_xor_sync(kFull, v, off), __shfl_xor_sync(kFull, r, off));
  if (lane == 0) {
    warp_val[warp] = v;
    warp_row[warp] = r;
  }
  __syncthreads();
  if (warp == 0) {
    v = warp_val[lane];
    r = warp_row[lane];
    for (int off = 16; off > 0; off >>= 1)
      better(v, r, __shfl_xor_sync(kFull, v, off), __shfl_xor_sync(kFull, r, off));
    if (lane == 0) *s_row = r;
  }
  __syncthreads();
  return *s_row;
}

// One block a set of any length l (see the note at the top): the head's
// coordinates in shared memory and minima in registers, the tail's
// coordinates read from pts and minima kept in tail_mind (l - kLongHead
// floats a set) every step.
__global__ void __launch_bounds__(kLongThreads, 1)
fps_long_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
                float* __restrict__ tail_mind, int* __restrict__ out, int l, int nsamp) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + kLongHead;
  float* sz = sy + kLongHead;
  __shared__ float warp_val[kLongWarps];
  __shared__ int warp_row[kLongWarps];
  __shared__ int s_row;

  const int set = blockIdx.x, t = threadIdx.x;
  const int head = min(l, kLongHead), tail = l - head;
  const float* p = pts + (size_t)set * l * 3;
  const unsigned char* v = valid + (size_t)set * l;
  float* tm = tail_mind + (size_t)set * tail;

  // load, init the running minima, find the first valid row (else l - 1)
  float mind[kLongPer];
  int first = l - 1;
#pragma unroll
  for (int k = 0; k < kLongPer; ++k) {
    const int j = t + k * kLongThreads;
    mind[k] = -INFINITY;                       // a slot past the head: never read
    if (j < head) {
      sx[j] = p[(size_t)j * 3 + 0];
      sy[j] = p[(size_t)j * 3 + 1];
      sz[j] = p[(size_t)j * 3 + 2];
      const bool ok = v[j] != 0;
      mind[k] = ok ? kBig : -kBig;
      if (ok) first = min(first, j);
    }
  }
  for (int j = head + t; j < l; j += kLongThreads) {
    const bool ok = v[j] != 0;
    tm[j - head] = ok ? kBig : -kBig;
    if (ok) first = min(first, j);
  }
  // the lowest valid row: all values tie, so the lowest row wins
  int last = long_argmax(0.f, first, warp_val, warp_row, &s_row);

  int* o = out + (size_t)set * nsamp;
  for (int i = 0; i < nsamp; ++i) {
    if (t == 0) o[i] = last;
    float lx, ly, lz;
    if (last < head) {
      lx = sx[last];
      ly = sy[last];
      lz = sz[last];
    } else {
      lx = p[(size_t)last * 3 + 0];
      ly = p[(size_t)last * 3 + 1];
      lz = p[(size_t)last * 3 + 2];
    }
    float bv = -INFINITY;
    int br = l;
    // rows rise within a thread (the head, then the tail): ties keep the first
#pragma unroll
    for (int k = 0; k < kLongPer; ++k) {
      const int j = t + k * kLongThreads;
      if (j < head) {
        const float m = fminf(mind[k], sq_dist(sx[j], sy[j], sz[j], lx, ly, lz));
        mind[k] = m;
        if (m > bv) {
          bv = m;
          br = j;
        }
      }
    }
    for (int j = head + t; j < l; j += kLongThreads) {
      const float* q = p + (size_t)j * 3;
      const float m = fminf(tm[j - head], sq_dist(q[0], q[1], q[2], lx, ly, lz));
      tm[j - head] = m;
      if (m > bv) {
        bv = m;
        br = j;
      }
    }
    last = long_argmax(bv, br, warp_val, warp_row, &s_row);
  }
}

}  // namespace

// pts (R, L, 3) f32, valid (R, L) bool, out (R, nsamp) int32; L <= 8192
// (see hvpr_fps_long for longer sets)
extern "C" int hvpr_fps_chunks(const float* pts, const unsigned char* valid,
                               int* out, int r, int l, int nsamp, void* stream) {
  const size_t smem = (size_t)4 * l * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<<<r, kThreads, smem, (cudaStream_t)stream>>>(pts, valid, out, l, nsamp);
  return (int)cudaGetLastError();
}

// rows of a set fps_long_kernel holds on chip; a longer set needs
// tail_mind of R x (L - this) floats
extern "C" int hvpr_fps_long_head() { return kLongHead; }

// pts (R, L, 3) f32, valid (R, L) bool, out (R, nsamp) int32, any L >= 1;
// tail_mind: R x max(0, L - hvpr_fps_long_head()) f32 scratch
extern "C" int hvpr_fps_long(const float* pts, const unsigned char* valid, float* tail_mind,
                             int* out, int r, int l, int nsamp, void* stream) {
  const size_t smem = (size_t)3 * kLongHead * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_long_kernel<<<r, kLongThreads, smem, (cudaStream_t)stream>>>(pts, valid, tail_mind,
                                                                   out, l, nsamp);
  return (int)cudaGetLastError();
}
