// Fused memory lookup: logits -> top-k superset threshold -> softmax @ memory
// (K2).
//
// Replaces: hvpr_tpu/ops/memory_lookup.py, memory_lookup_fused (:127) and its
// three Pallas kernels _bmax_kernel (:53), _thresh_kernel (:87, with
// _thresh_loop :64) and _apply_kernel (:97), with the semantics of its
// _emulation (:109): bf16-rounded inputs, padded memory columns at -1e30,
// bucket b = max over columns == b mod 128, threshold = k-th largest bucket
// max counting ties, row max = max bucket max, w = e / sum(e) with
// e = exp(l - max) * [l >= threshold], out = bf16(w) @ bf16(memory).
//
// Accumulation: a product of two bf16 values is exact in f64, and a sum of
// C = 64 of them stays exact in f64 unless the terms span more than ~46
// binary orders; each logit and output element is therefore accumulated in
// f64 and rounded to f32 once (sum(e) likewise). The JAX package accumulates
// in f32, a difference of an f32 ulp; in exchange the result does not depend
// on summation order, so this kernel and its plain version
// (ops/memory_lookup.py) give the same bits on the card and a pipeline run
// through either yields the same detections.
//
// What bounds it on the H100: operations. Per pillar row the dense work is
// M*C multiply-adds for the logits and M*C for the output (4*R*M*C flops)
// against ~8*C bytes of input and output, far above the card's ~295 flops per
// byte at the bf16 tensor rate. This kernel runs its multiply-adds on the f64
// CUDA cores (for the order-free sums above), so it runs far from that
// bound; tensor-core tiles with an exact split are later work.
//
// Design: one block owns 16 pillar rows and keeps all their logits in shared
// memory (16 x Mp f32, 128 KB at M = 2000), so nothing is recomputed and
// sum(e) is known before the weights are rounded. The bf16 memory padded to
// 2048 x 64 is 262 KB, more than the 227 KB a block can hold, so it is
// streamed in 128-row chunks, held as f64 (64 KB; f64 operands spare a
// conversion per multiply-add): every chunk gives each bucket exactly one
// column, and 8 warps split a chunk's 128 columns x 16 rows. The
// threshold needs no sort: a warp owns a row, each lane holds 4 of the 128
// bucket maxima and counts how many are greater and greater-or-equal; the
// value with greater < k <= greater-or-equal is the k-th largest. The warp
// then overwrites the row's logits with its bf16-rounded weights, and the
// output streams the memory chunks again: 16 threads share a row, each
// owning C/16 channels, and a warp skips the columns where its 2 rows have zero
// weight (a pillar row selects ~k of 2000 columns). Rows outside the caller's
// row mask (empty pillar slots, ~40% at hvpr.yaml's batch 8) output zeros,
// and a block without a valid row returns at once: the counterpart of the
// JAX package's eighth-prefix switch. An all-zero row inside the mask ties
// everywhere, selects every column and runs the whole dense product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 16;     // pillar rows per block
constexpr int kChunk = 128;   // memory rows per streamed chunk == buckets
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowThreads = kThreads / kRows;   // threads sharing a row: 16
constexpr int kColRows = kRows * kChunk / kThreads;  // logit rows a thread owns: 8
constexpr int kStride = kChunk + 1;   // transposed chunk row: no bank conflicts
constexpr int kMaxC = 64;
constexpr float kNeg = -1e30f;

// Chunk `ch` (memory rows ch * 128 ...) of the (M, C) bf16 memory as f64 in
// shared memory, transposed (C rows of kStride) or row-major (128 x C), zero
// past M. 16-byte loads, all in flight before the first store: a chunk load
// is otherwise a chain of dependent L2 round trips.
template <bool kTransposed>
__device__ void load_chunk(const __nv_bfloat16* mem, double* chunk, int ch,
                           int M, int C) {
  constexpr int kMaxVec = kChunk * kMaxC / 8 / kThreads;
  const int vpr = C / 8;                    // 16-byte vectors per memory row
  const int nvec = kChunk * vpr;
  const uint4* src = reinterpret_cast<const uint4*>(mem) +
                     static_cast<long long>(ch) * kChunk * vpr;
  uint4 v[kMaxVec];
  for (int u = 0; u < kMaxVec; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const bool ok = i < nvec && ch * kChunk + i / vpr < M;
    v[u] = ok ? src[i] : make_uint4(0, 0, 0, 0);
  }
  for (int u = 0; u < kMaxVec; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < nvec) {
      const int n = i / vpr;
      const int c0 = (i - n * vpr) * 8;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[u]);
      for (int j = 0; j < 8; ++j) {
        const double d = __bfloat162float(e[j]);
        if (kTransposed) {
          chunk[(c0 + j) * kStride + n] = d;
        } else {
          chunk[n * C + c0 + j] = d;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
memory_lookup_kernel(const float* __restrict__ pillars,
                     const __nv_bfloat16* __restrict__ mem,
                     const bool* __restrict__ row_mask,
                     float* __restrict__ out, float* __restrict__ thresh_out,
                     int* __restrict__ count_out, int R, int M, int C, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Mp = (M + kChunk - 1) / kChunk * kChunk;
  const int n_chunks = Mp / kChunk;
  double* chunk = reinterpret_cast<double*>(smem);          // C x kStride | 128 x C
  double* pill = chunk + C * kStride;                               // kRows x C
  float* logits = reinterpret_cast<float*>(pill + kRows * C);       // kRows x Mp
  float* bmax = logits + kRows * Mp;                                // kRows x 128

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRows;

  // 0. rows outside row_mask output zeros; a block with none inside exits
  __shared__ int any_valid;
  if (threadIdx.x == 0) any_valid = 0;
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int row = row0 + threadIdx.x;
    if (row < R && (row_mask == nullptr || row_mask[row])) any_valid = 1;
  }
  __syncthreads();
  if (!any_valid) {
    for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
      const int row = row0 + i / C;
      if (row < R) out[static_cast<long long>(row0) * C + i] = 0.0f;
    }
    if (threadIdx.x < kRows && row0 + threadIdx.x < R) {
      if (thresh_out != nullptr) thresh_out[row0 + threadIdx.x] = 0.0f;
      if (count_out != nullptr) count_out[row0 + threadIdx.x] = 0;
    }
    return;
  }

  // 1. the pillar tile, rounded to bf16 (rows past R are zero)
  for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
    const int r = i / C;
    const int row = row0 + r;
    const float v =
        row < R ? pillars[static_cast<long long>(row) * C + (i - r * C)] : 0.0f;
    pill[i] = __bfloat162float(__float2bfloat16_rn(v));
  }

  // 2. all logits of the tile; memory chunks stored transposed (C rows of
  //    kStride) so a warp reads 32 consecutive columns; thread t owns
  //    column t % 128 of rows kColRows * (t / 128) ...
  for (int ch = 0; ch < n_chunks; ++ch) {
    __syncthreads();
    load_chunk<true>(mem, chunk, ch, M, C);
    __syncthreads();
    const int t = threadIdx.x % kChunk;
    const int rb = threadIdx.x / kChunk * kColRows;
    double acc[kColRows];
    for (int r = 0; r < kColRows; ++r) acc[r] = 0.0;
    for (int c = 0; c < C; c += 2) {
      const double m0 = chunk[c * kStride + t];
      const double m1 = chunk[(c + 1) * kStride + t];
      for (int r = 0; r < kColRows; ++r) {
        const double2 p = *reinterpret_cast<const double2*>(pill + (rb + r) * C + c);
        acc[r] = fma(p.y, m1, fma(p.x, m0, acc[r]));
      }
    }
    const int col = ch * kChunk + t;
    for (int r = 0; r < kColRows; ++r) {
      logits[(rb + r) * Mp + col] = col < M ? __double2float_rn(acc[r]) : kNeg;
    }
  }
  __syncthreads();

  // 3. bucket maxima
  for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
    const int r = i / kChunk;
    const int b = i - r * kChunk;
    float v = logits[r * Mp + b];
    for (int ch = 1; ch < n_chunks; ++ch) {
      v = fmaxf(v, logits[r * Mp + ch * kChunk + b]);
    }
    bmax[i] = v;
  }
  __syncthreads();

  // 4. per row (one warp): threshold, row max, sum(e); the row's logits are
  //    then overwritten with its bf16-rounded weights
  for (int r = warp; r < kRows; r += kWarps) {
    const float* bm = bmax + r * kChunk;
    float v[4];
    int gt[4], ge[4];
    for (int q = 0; q < 4; ++q) {
      v[q] = bm[lane * 4 + q];
      gt[q] = 0;
      ge[q] = 0;
    }
    for (int j = 0; j < kChunk; ++j) {
      const float u = bm[j];
      for (int q = 0; q < 4; ++q) {
        gt[q] += u > v[q];
        ge[q] += u >= v[q];
      }
    }
    float th = -CUDART_INF_F;
    float mx = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
    for (int q = 0; q < 4; ++q) {
      if (gt[q] < k && k <= ge[q]) th = fmaxf(th, v[q]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      th = fmaxf(th, __shfl_xor_sync(0xffffffffu, th, off));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    float* lr = logits + r * Mp;
    double s = 0.0;
    int cnt = 0;
    for (int j = lane; j < Mp; j += 32) {
      const float l = lr[j];
      if (l >= th) {
        s += expf(l - mx);
        ++cnt;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    }
    const float s32 = __double2float_rn(s);
    for (int j = lane; j < Mp; j += 32) {
      const float l = lr[j];
      lr[j] = l >= th ? __bfloat162float(__float2bfloat16_rn(expf(l - mx) / s32))
                      : 0.0f;
    }
    const int row = row0 + r;
    const bool valid = row < R && (row_mask == nullptr || row_mask[row]);
    if (lane == 0 && row < R) {
      if (thresh_out != nullptr) thresh_out[row] = valid ? th : 0.0f;
      if (count_out != nullptr) count_out[row] = valid ? cnt : 0;
    }
  }

  // 5. out = w @ memory over the chunks again; thread (r, q) owns row r and
  //    channels q, q + 16, ...
  const int r = threadIdx.x / kRowThreads;
  const int q = threadIdx.x % kRowThreads;
  const int cpt = C / kRowThreads;
  double acc[kMaxC / kRowThreads];
  for (int i = 0; i < kMaxC / kRowThreads; ++i) acc[i] = 0.0;
  const float* wr = logits + r * Mp;
  for (int ch = 0; ch < n_chunks; ++ch) {
    __syncthreads();
    load_chunk<false>(mem, chunk, ch, M, C);
    __syncthreads();
    // a lane of each half-warp checks one of 16 columns; the warp visits
    // the columns where either of its two rows has a nonzero weight
    for (int n0 = 0; n0 < kChunk; n0 += kRowThreads) {
      const unsigned bal = __ballot_sync(
          0xffffffffu, wr[ch * kChunk + n0 + q] != 0.0f);
      unsigned cols = (bal | (bal >> kRowThreads)) & 0xffffu;
      while (cols) {
        const int n = n0 + __ffs(cols) - 1;
        cols &= cols - 1;
        const double wd = wr[ch * kChunk + n];
        const double* mrow = chunk + n * C + q;
        for (int i = 0; i < kMaxC / kRowThreads; ++i) {
          if (i < cpt) acc[i] = fma(wd, mrow[i * kRowThreads], acc[i]);
        }
      }
    }
  }
  const int row = row0 + r;
  if (row < R) {
    const bool valid = row_mask == nullptr || row_mask[row];
    for (int i = 0; i < kMaxC / kRowThreads; ++i) {
      if (i < cpt) {
        out[static_cast<long long>(row) * C + q + i * kRowThreads] =
            valid ? __double2float_rn(acc[i]) : 0.0f;
      }
    }
  }
}

}  // namespace

// pillars (R, C) f32, mem (M, C) bf16, out (R, C) f32, all contiguous;
// row_mask (R,) bool may be null (all rows); rows outside it get out = 0,
// thresh = 0, count = 0. thresh (R,) f32 and count (R,) int32 may be null. C % 16 == 0, C <= 64,
// 1 <= k <= 128. Returns cudaGetLastError() after the launch.
extern "C" int hvpr_memory_lookup(const float* pillars, const void* mem,
                                  const void* row_mask, float* out,
                                  float* thresh, int* count, int R, int M,
                                  int C, int k, void* stream) {
  const int Mp = (M + kChunk - 1) / kChunk * kChunk;
  const size_t smem = static_cast<size_t>(C) * kStride * 8 + kRows * C * 8 +
                      static_cast<size_t>(kRows) * Mp * 4 + kRows * kChunk * 4;
  cudaError_t e = cudaFuncSetAttribute(
      memory_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (R + kRows - 1) / kRows;
  memory_lookup_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      pillars, static_cast<const __nv_bfloat16*>(mem),
      static_cast<const bool*>(row_mask), out, thresh, count, R,
      M, C, k);
  return static_cast<int>(cudaGetLastError());
}
