// Chunk-parallel exact furthest point sampling (kernel K5), CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel hvpr_tpu/ops/pn2_select.py:302
// (`fps_chunks_pallas` / `_fps_kernel` :251), which runs exact FPS inside
// each Morton chunk with all (batch x chunk) sets on the 128 lanes at once
// and every operand resident in VMEM.
//
// Here one block owns one point set: its L <= 8192 points and their running
// minimum distances live in shared memory for the whole loop. Each of the
// `nsamp` steps updates the minimum distance of every row against the last
// sample, then runs a block argmax (largest distance, ties to the lowest
// row: the plain version's `min(where(mind == max, rows, L-1))`), then
// broadcasts the winner through shared memory.
//
// Bound: the steps are a chain, each waiting for the previous argmax, and
// there are only R blocks (64 at hvpr.yaml's shapes, half the SMs), so the
// latency of one step (~2 block barriers and a shuffle tree) times `nsamp`
// bounds it, far above both its operation bound (~10 f32 operations per
// row and step at 67 TFLOP/s) and its byte bound.
//
// Exactness: squared distances are ((dx*dx + dy*dy) + dz*dz) with every
// product and sum rounded on its own (__fmul_rn/__fadd_rn: no FMA
// contraction), the plain version's order, so near-ties resolve the same.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;

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
      const float dx = __fsub_rn(sx[j], lx);
      const float dy = __fsub_rn(sy[j], ly);
      const float dz = __fsub_rn(sz[j], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(mind[j], d);
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

}  // namespace

extern "C" int hvpr_fps_chunks(const float* pts, const unsigned char* valid,
                               int* out, int r, int l, int nsamp, void* stream) {
  const size_t smem = (size_t)4 * l * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<<<r, kThreads, smem, (cudaStream_t)stream>>>(pts, valid, out, l, nsamp);
  return (int)cudaGetLastError();
}
