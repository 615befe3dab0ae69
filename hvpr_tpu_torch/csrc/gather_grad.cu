// Deterministic backward of a row gather (K12; not a TPU kernel).
//
// Stands in for: the backward of hvpr_tpu/ops/pointnet2.py group_points
// (:189), an XLA gather whose scatter-add backward the TPU sums in a fixed
// order. torch.gather's backward on the card is a scatter-add by float
// atomics, whose order, and so whose rounding, changes from run to run:
// the point stream's 3-NN interpolation and grouping repeat indices, and
// two train steps differed by ~3% of a point-stream gradient.
//
// What bounds it on the H100: memory. Each incoming gradient row is read
// once and each output row written once.
//
// Design: the wrapper sorts the target rows stably (so each target's
// contributions keep their source order) and finds each target's range of
// the sorted list by binary search, both on the device. The kernel gives a
// thread to each (target row, channel), neighbouring threads to
// neighbouring channels of a row, and sums the target's contributions in
// f32 one after the other in that order, then writes the sum once in the
// output dtype (round to nearest even for bf16). No atomics: the same
// inputs give the same bits on every run, and the bits of the plain
// version (an f32 index_add_ in source order, as the CPU runs it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kInBf16>
__device__ __forceinline__ float load(const void* p, long long i) {
  if (kInBf16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

template <bool kBf16>
__global__ void gather_grad_kernel(const void* __restrict__ grad,
                                   const long long* __restrict__ order,
                                   const long long* __restrict__ offsets,
                                   void* __restrict__ out, long long targets, int C) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= targets * C) return;
  const long long row = t / C;
  const int c = static_cast<int>(t - row * C);
  const long long end = offsets[row + 1];
  float acc = 0.0f;
  for (long long j = offsets[row]; j < end; ++j) {
    acc = __fadd_rn(acc, load<kBf16>(grad, order[j] * C + c));
  }
  if (kBf16) {
    static_cast<__nv_bfloat16*>(out)[t] = __float2bfloat16_rn(acc);
  } else {
    static_cast<float*>(out)[t] = acc;
  }
}

}  // namespace

// grad (R, C) f32 (bf16 = 0) or bf16 (bf16 = 1), the gathered rows'
// gradient; order (R,) int64, the source rows sorted stably by target;
// offsets (targets + 1,) int64, target i's range [offsets[i],
// offsets[i + 1]) of order; out (targets, C) in grad's dtype. Returns
// cudaGetLastError() after the launch.
extern "C" int hvpr_gather_grad(const void* grad, const long long* order,
                                const long long* offsets, void* out, long long targets,
                                int C, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = targets * C;
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (bf16) {
    gather_grad_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        grad, order, offsets, out, targets, C);
  } else {
    gather_grad_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        grad, order, offsets, out, targets, C);
  }
  return static_cast<int>(cudaGetLastError());
}
