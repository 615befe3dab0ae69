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
// M*C multiply-adds for the logits (2*R*M*C flops, 1.95e10 at hvpr.yaml's
// batch 8: ~76,000 valid rows, M = 2000, C = 64) against ~8*C bytes of input
// and output, far above the card's ~295 flops per byte at the bf16 tensor
// rate (0.020 ms). The exact f64 sums above need f64 products: this kernel
// runs the logits on the FP64 tensor cores (mma.sync.aligned.m8n8k4 .f64,
// DMMA, as K7 in memory_recon.cu), whose 67 TFLOP/s bound the logits at
// ~0.29 ms. The output touches only the ~23 selected columns of a row.
//
// Design: one block owns 16 pillar rows and 16 warps, one sweep over the
// memory. The bf16 memory (262 KB padded to 2048 x 64: more than a block's
// 227 KB) streams through shared memory in 128-row chunks as bf16 (18 KB
// each, rows padded to 144 bytes so a fragment load hits 16 distinct
// banks), double-buffered with cp.async, so the next chunk's copy overlaps
// this chunk's products. Every chunk gives each bucket exactly one column.
// A warp owns the block's 16 rows x 8 columns of a chunk: its pillar
// fragments (bf16-rounded, widened to f64) stay in registers for the whole
// sweep, and each memory fragment is widened to f64 as it is loaded (exact)
// and feeds two DMMAs. The logits, rounded to f32, go to a shared tile (16 x
// (Mp + 8) f32, 129 KB; the pad keeps the 8-byte stores conflict-free) and
// each lane keeps the maxima of its 4 (row, bucket) pairs in registers over
// the chunks. Then a warp owns a row: the threshold by counting (each lane
// holds 4 of the 128 bucket maxima and counts how many are greater and
// greater-or-equal; the value with greater < k <= greater-or-equal is the
// k-th largest), one pass over the row's logits for sum(e) that also lists
// the selected columns in index order (ballots) with their e in shared
// memory (in the chunk buffers, free after the sweep), and the output from
// that list: lanes over channels, the selected memory rows read from global
// memory (L2), 8 rows' loads in flight. A row that selects more than kCap =
// 128 columns (a tie: an all-zero row ties with every column) overwrites
// its logits with its weights and sums every column with a nonzero weight
// instead, so any count from 0 to M is right. Rows outside the caller's row
// mask (empty pillar slots, ~40% at hvpr.yaml's batch 8) output zeros, and a
// block without a valid row returns at once: the counterpart of the JAX
// package's eighth-prefix switch.
//
// The tile keeps all its logits, so the sweep runs once, but the tile's 176
// KB of shared memory leave one block an SM. The other layout, two sweeps
// over 32-row tiles with no logit tile (86 KB, two blocks an SM: bucket
// maxima first, then each row's selected columns appended to a list), made
// twice the DMMA work and was slower on the card (PERF.md, K2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dmma.cuh"

namespace {

constexpr int kRows = 16;                       // pillar rows per block
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;                     // memory rows per chunk == buckets
constexpr int kWCols = kChunk / kWarps;         // a warp's columns of a chunk: 8
constexpr int kMaxC = 64;
constexpr int kKSteps = kMaxC / 4;              // mma k-steps at most
constexpr int kCS = kMaxC + 8;                  // bf16 row stride of a chunk (144 B)
constexpr int kChunkElems = kChunk * kCS;
constexpr int kLPad = 8;                        // f32 pad of a logit row
constexpr int kCap = 128;                       // list length a row
constexpr int kAhead = 8;                       // list rows whose loads are in flight
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kRows == 16 && kWCols == 8, "a warp's tile: two 8 x 8 mma tiles");
static_assert(kRows * kCap * 8 <= 2 * kChunkElems * 2, "the lists fit the chunk buffers");

using hvpr::bf16_round;
using hvpr::dmma;
using hvpr::widen;

// Start copying chunk `ch` (memory rows ch * 128 ...) of the (M, C) bf16
// memory into dst (rows of kCS), 16 bytes a copy; rows past M are zeros.
__device__ __forceinline__ void stage_chunk(const __nv_bfloat16* __restrict__ mem,
                                            __nv_bfloat16* dst, int ch, int M, int C) {
  hvpr::stage_rows<kChunk, kCS, kThreads>(mem, dst, ch * kChunk, M, C);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// k-th largest of a row's 128 bucket maxima, ties counted (one warp)
__device__ float kth_largest(const float* bm, int k, int lane) {
  float v[4];
  int gt[4], ge[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = bm[lane * 4 + q];
    gt[q] = 0;
    ge[q] = 0;
  }
  for (int j = 0; j < kChunk; ++j) {
    const float u = bm[j];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      gt[q] += u > v[q];
      ge[q] += u >= v[q];
    }
  }
  float th = -CUDART_INF_F;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (gt[q] < k && k <= ge[q]) th = fmaxf(th, v[q]);
  return warp_max(th);
}

__device__ __forceinline__ void add_column(const __nv_bfloat16* __restrict__ mem, int j,
                                           double w, int C, int lane, double& a0, double& a1) {
  const __nv_bfloat16* mr = mem + (size_t)j * C;
  if (lane < C) a0 = fma(w, widen(mr[lane]), a0);
  if (lane + 32 < C) a1 = fma(w, widen(mr[lane + 32]), a1);
}

// out += sum over a row's list of its bf16 weights lv times the memory rows
// li, in list order (columns past M, which weigh 0, add 0); lanes over
// channels, kAhead rows' loads in flight before their multiply-adds
__device__ __forceinline__ void output_from_list(const __nv_bfloat16* __restrict__ mem,
                                                 const int* li, const float* lv, int cnt,
                                                 int M, int C, int lane, double& a0,
                                                 double& a1) {
  for (int e0 = 0; e0 < cnt; e0 += kAhead) {
    float w[kAhead];
    __nv_bfloat16 m0[kAhead], m1[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int e = min(e0 + u, cnt - 1);
      const int j = li[e];
      const bool use = e0 + u < cnt && j < M;
      w[u] = use ? lv[e] : 0.0f;
      const __nv_bfloat16* mr = mem + (size_t)(use ? j : 0) * C;
      m0[u] = mr[lane < C ? lane : 0];
      m1[u] = mr[lane + 32 < C ? lane + 32 : 0];
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (e0 + u < cnt) {
        if (lane < C) a0 = fma((double)w[u], widen(m0[u]), a0);
        if (lane + 32 < C) a1 = fma((double)w[u], widen(m1[u]), a1);
      }
    }
  }
}

__device__ __forceinline__ void finish_row(float* __restrict__ out, float* __restrict__ thresh_out,
                                           int* __restrict__ count_out, int row, int C,
                                           int lane, double a0, double a1, float th, int cnt) {
  float* orow = out + (size_t)row * C;
  if (lane < C) orow[lane] = __double2float_rn(a0);
  if (lane + 32 < C) orow[lane + 32] = __double2float_rn(a1);
  if (lane == 0) {
    if (thresh_out != nullptr) thresh_out[row] = th;
    if (count_out != nullptr) count_out[row] = cnt;
  }
}

__global__ void __launch_bounds__(kThreads)
memory_lookup_kernel(const float* __restrict__ pillars,
                     const __nv_bfloat16* __restrict__ mem,
                     const bool* __restrict__ row_mask, float* __restrict__ out,
                     float* __restrict__ thresh_out, int* __restrict__ count_out, int R,
                     int M, int C, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Mp = (M + kChunk - 1) / kChunk * kChunk;
  const int n_chunks = Mp / kChunk;
  const int LS = Mp + kLPad;
  __nv_bfloat16* chunks = reinterpret_cast<__nv_bfloat16*>(smem);    // 2 x kChunkElems
  float* logits = reinterpret_cast<float*>(chunks + 2 * kChunkElems); // kRows x LS
  float* bmax = logits + kRows * LS;                                   // kRows x 128
  int* lidx = reinterpret_cast<int*>(smem);                  // kRows x kCap, after the sweep
  float* lval = reinterpret_cast<float*>(lidx + kRows * kCap);         // kRows x kCap
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.x * kRows;

  // 0. rows outside row_mask output zeros; a block with none inside exits
  const int t = threadIdx.x;
  if (!__syncthreads_or(t < kRows && row0 + t < R &&
                        (row_mask == nullptr || row_mask[row0 + t]))) {
    for (int i = t; i < kRows * C; i += kThreads)
      if (row0 + i / C < R) out[(size_t)row0 * C + i] = 0.0f;
    if (t < kRows && row0 + t < R) {
      if (thresh_out != nullptr) thresh_out[row0 + t] = 0.0f;
      if (count_out != nullptr) count_out[row0 + t] = 0;
    }
    return;
  }

  stage_chunk(mem, chunks, 0, M, C);

  // 1. the warp's pillar fragments, bf16-rounded and widened: a[i][ks] =
  //    pillar[row0 + 8 i + g][4 ks + q] (zero past R)
  const int ksteps = C / 4;
  double a[2][kKSteps];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8 + g;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const float v = row < R && ks < ksteps ? pillars[(size_t)row * C + ks * 4 + q] : 0.0f;
      a[i][ks] = (double)bf16_round(v);
    }
  }

  // 2. the sweep: the logits of the warp's 16 rows x 8 columns of each
  //    chunk on DMMA, rounded to f32 into the logit tile; bucket maxima in
  //    registers (bm[i][h]: row 8 i + g, bucket wc + 2 q + h)
  const int wc = warp * kWCols;
  float bm[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) bm[i][0] = bm[i][1] = -CUDART_INF_F;
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      stage_chunk(mem, chunks + ((ch + 1) & 1) * kChunkElems, ch + 1, M, C);
      hvpr::cp_async_wait<1>();
    } else {
      hvpr::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* cb = chunks + (ch & 1) * kChunkElems;
    double acc[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      if (ks < ksteps) {
        const double b = widen(cb[(wc + g) * kCS + ks * 4 + q]);
#pragma unroll
        for (int i = 0; i < 2; ++i) dmma(acc[i][0], acc[i][1], a[i][ks], b);
      }
    }
    const int col = ch * kChunk + wc + 2 * q;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float l0 = col < M ? __double2float_rn(acc[i][0]) : kNeg;
      const float l1 = col + 1 < M ? __double2float_rn(acc[i][1]) : kNeg;
      *reinterpret_cast<float2*>(logits + (i * 8 + g) * LS + col) = make_float2(l0, l1);
      bm[i][0] = fmaxf(bm[i][0], l0);
      bm[i][1] = fmaxf(bm[i][1], l1);
    }
    __syncthreads();                    // the buffer is refilled next round
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    *reinterpret_cast<float2*>(bmax + (i * 8 + g) * kChunk + wc + 2 * q) =
        make_float2(bm[i][0], bm[i][1]);
  __syncthreads();

  // 3. a warp a row: threshold, row max, sum(e) and the list of selected
  //    columns, then the output
  const unsigned below = (1u << lane) - 1u;
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = row0 + r;
    if (row >= R) continue;
    if (row_mask != nullptr && !row_mask[row]) {
      finish_row(out, thresh_out, count_out, row, C, lane, 0.0, 0.0, 0.0f, 0);
      continue;
    }
    const float* bmr = bmax + r * kChunk;
    const float th = kth_largest(bmr, k, lane);
    const float mx = warp_max(fmaxf(fmaxf(bmr[lane * 4], bmr[lane * 4 + 1]),
                                    fmaxf(bmr[lane * 4 + 2], bmr[lane * 4 + 3])));
    float* lr = logits + r * LS;
    int* li = lidx + r * kCap;
    float* lv = lval + r * kCap;
    double s = 0.0;
    int cnt = 0;
    for (int j0 = 0; j0 < Mp; j0 += 32) {
      const int j = j0 + lane;
      const float l = lr[j];
      const bool pick = l >= th;
      float e = 0.0f;
      if (pick) {
        e = expf(__fsub_rn(l, mx));
        s += (double)e;
      }
      const unsigned ball = __ballot_sync(kFull, pick);
      if (pick) {
        const int pos = cnt + __popc(ball & below);
        if (pos < kCap) {
          li[pos] = j;
          lv[pos] = e;
        }
      }
      cnt += __popc(ball);
    }
    __syncwarp();                       // the list, written by the picking lanes
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    const float s32 = __double2float_rn(s);
    double a0 = 0.0, a1 = 0.0;
    if (cnt <= kCap) {
      for (int e = lane; e < cnt; e += 32) lv[e] = bf16_round(__fdiv_rn(lv[e], s32));
      __syncwarp();
      output_from_list(mem, li, lv, cnt, M, C, lane, a0, a1);
    } else {
      // an overflow row: its weights over the logits, then every column with
      // a nonzero weight
      for (int j = lane; j < Mp; j += 32) {
        const float l = lr[j];
        lr[j] = l >= th ? bf16_round(__fdiv_rn(expf(__fsub_rn(l, mx)), s32)) : 0.0f;
      }
      __syncwarp();
      for (int j0 = 0; j0 < Mp; j0 += 32) {
        const float wl = lr[j0 + lane];
        unsigned nz = __ballot_sync(kFull, wl != 0.0f);
        while (nz) {
          const int b = __ffs(nz) - 1;
          nz &= nz - 1;
          add_column(mem, j0 + b, (double)__shfl_sync(kFull, wl, b), C, lane, a0, a1);
        }
      }
    }
    finish_row(out, thresh_out, count_out, row, C, lane, a0, a1, th, cnt);
  }
}

}  // namespace

// shared memory a block needs for M memory rows
extern "C" long long hvpr_memory_lookup_smem(int M) {
  const int Mp = (M + kChunk - 1) / kChunk * kChunk;
  return 2LL * kChunkElems * 2 + 4LL * kRows * (Mp + kLPad) + 4LL * kRows * kChunk;
}

// pillars (R, C) f32, mem (M, C) bf16, out (R, C) f32, all contiguous;
// row_mask (R,) bool may be null (all rows); rows outside it get out = 0,
// thresh = 0, count = 0. thresh (R,) f32 and count (R,) int32 may be null.
// C % 16 == 0, C <= 64, 1 <= k <= 128. Returns cudaGetLastError() after the
// launch.
extern "C" int hvpr_memory_lookup(const float* pillars, const void* mem,
                                  const void* row_mask, float* out,
                                  float* thresh, int* count, int R, int M,
                                  int C, int k, void* stream) {
  const size_t smem = (size_t)hvpr_memory_lookup_smem(M);
  cudaError_t e = cudaFuncSetAttribute(
      memory_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  memory_lookup_kernel<<<(R + kRows - 1) / kRows, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      pillars, static_cast<const __nv_bfloat16*>(mem),
      static_cast<const bool*>(row_mask), out, thresh, count, R, M, C, k);
  return static_cast<int>(cudaGetLastError());
}
