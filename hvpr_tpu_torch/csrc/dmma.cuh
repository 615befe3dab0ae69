// Helpers shared by the kernels that run their products on the FP64 tensor
// cores (K2 memory_lookup.cu, K6/K7 memory_recon.cu, K8/K9 topk_attend.cu):
// the DMMA instructions, bf16 widening and rounding, and cp.async staging of
// bf16 rows into shared memory. Included by each source; ops/_kernels.py
// hashes every header of csrc/ into each library's name, so an edit here
// rebuilds all of them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hvpr {

// D (8 x 8) += A (8 x 4) B (4 x 8) on the FP64 tensor cores. Per lane:
// a = A[lane / 4][lane % 4], b = B[lane % 4][lane / 4], and
// d0, d1 = D[lane / 4][2 (lane % 4) + {0, 1}].
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

// D (16 x 8) += A (16 x K) B (K x 8) on the FP64 tensor cores, K = 4, 8 or
// 16 (the m16n8k* shapes of sm_90). Per lane, g = lane / 4, q = lane % 4:
// a[i] = A[g + 8 (i % 2)][q + 4 (i / 2)] (i < K / 2), b[i] = B[q + 4 i][g]
// (i < K / 4), and d = D[g][2q], D[g][2q + 1], D[g + 8][2q], D[g + 8][2q + 1].
__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[2],
                                       const double (&b)[1]) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
               "{%4, %5}, {%6}, {%0, %1, %2, %3};"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[4],
                                       const double (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ void dmma16(double (&d)[4], const double (&a)[8],
                                       const double (&b)[4]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
               "{%0, %1, %2, %3};"
               : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
                 "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// a bf16 value widened to f64 (exact)
__device__ __forceinline__ double widen(__nv_bfloat16 v) { return (double)__bfloat162float(v); }

// K / 4 consecutive bf16 values at p (aligned to K / 2 bytes) widened to
// f64, K = 4, 8 or 16: one 2, 4 or 8-byte load
template <int K>
__device__ __forceinline__ void widen_run(const __nv_bfloat16* p, double (&v)[K / 4]) {
  if constexpr (K == 4) {
    v[0] = widen(p[0]);
  } else if constexpr (K == 8) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = widen(x.x);
    v[1] = widen(x.y);
  } else {
    static_assert(K == 16, "K = 4, 8 or 16");
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
    v[0] = widen(lo.x);
    v[1] = widen(lo.y);
    v[2] = widen(hi.x);
    v[3] = widen(hi.y);
  }
}

// an f32 value rounded to bf16 and back
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Start copying rows [row0, row0 + ROWS) of a row-major (n_rows, C) bf16
// matrix into dst (a row every STRIDE elements), 16 bytes a copy by THREADS
// threads; rows past n_rows are zeros. C % 8 == 0. Commits one cp.async
// group.
template <int ROWS, int STRIDE, int THREADS>
__device__ __forceinline__ void stage_rows(const __nv_bfloat16* __restrict__ src,
                                           __nv_bfloat16* dst, int row0, int n_rows, int C) {
  const int vpr = C / 8;
  for (int i = threadIdx.x; i < ROWS * vpr; i += THREADS) {
    const int n = i / vpr, v = i - n * vpr;
    const int row = row0 + n;
    const __nv_bfloat16* s = src + (size_t)min(row, n_rows - 1) * C + v * 8;
    const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst + n * STRIDE + v * 8);
    const int bytes = row < n_rows ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(saddr), "l"(s), "r"(bytes));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N cp.async groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace hvpr
