// Exact furthest point sampling inside each of R point sets (kernel K5),
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel hvpr_tpu/ops/pn2_select.py:302
// (`fps_chunks_pallas` / `_fps_kernel` :251), which runs exact FPS inside
// each Morton chunk with all (batch x chunk) sets on the 128 lanes at once
// and every operand resident in VMEM.
//
// What it computes: out[set, 0] is the lowest valid row (else L - 1); each
// of the `nsamp` steps lowers every row's running minimum to its squared
// distance ((dx*dx + dy*dy) + dz*dz, every product and sum rounded on its
// own: __fmul_rn/__fadd_rn, no FMA contraction, the plain version's order)
// from the last sample, and the next sample is the row with the largest
// minimum, ties to the lowest row (the plain version's
// `min(where(mind == max, rows, L-1))`). Invalid rows hold -1e30.
//
// What bounds it: the steps are a chain, each waiting for the last argmax,
// with few sets (64 at hvpr.yaml's chunked shapes, 4 for exact FPS at batch
// 4). A step's latency times `nsamp` bounds it, far above both its
// operation bound (~10 f32 operations a row and step at 67 TFLOP/s) and its
// byte bound. The argmax chain alone, with no distance work, measures that
// latency floor (PERF.md, K5: the lowest of the designs' chains, measured
// when K5 was redesigned).
//
// The step's argmax, in every design: each thread keeps its best (minimum,
// row) over its rows (rows rise within a thread, so ties keep the first);
// the minimum becomes an order-preserving u32 key (negative floats below
// every distance); a warp takes __reduce_max_sync of the keys, then
// __reduce_min_sync of the rows holding that key: the plain rule, ties to
// the lowest row, in two instructions and no serial loop. Warp results go to
// slots double-buffered by step parity; ONE barrier; then every warp reduces
// all slots itself the same way (no thread reduces them alone, and no second
// barrier hands out the result: the next step writes the other buffer).
//
// Designs: this file holds only those the entry points take, the fastest
// measured on the H100 when K5 was redesigned (PERF.md, K5); the others
// named below and the designs' argmax chains were measured beside them and
// are kept in the repository's history only:
// - block (hvpr_fps_chunks, 256 < L <= 8192: SA1's Morton chunks): one
//   block of 256 threads a set, each with its rows' coordinates and minima
//   in registers (PER rows a thread, templated, 256 * PER >= L); shared
//   memory holds a copy of the coordinates that the winner's broadcast
//   reads (one 16-byte load). A block of 1024 threads measured slower.
// - warp (hvpr_fps_chunks, L <= 256: SA2's chunks): one warp a set, 8 rows
//   a lane, no block barrier at all; a little faster than the block.
// - cluster, warps by st.async (hvpr_fps_long, L > 8192: exact FPS over a
//   scan): a thread-block cluster of 8 blocks a set, on 8 SMs, each block
//   holding its share of the first 8 * 256 * 16 rows' coordinates and
//   minima in registers; rows past that stream their coordinates from
//   device memory every step, their minima in `tail_mind`. One SM cannot
//   hold a scan's coordinates in registers, and its distances alone took
//   ~1.6 us a step against ~0.25 us on eight (H100 80GB HBM3, 700 W): the
//   exchange decides the rest. Each warp's winner lane sends (key, row, x,
//   y, z) into the slot arrays of all 8 blocks with st.async, which
//   completes bytes on an mbarrier in the receiving block; each block
//   waits on its own mbarrier (no block or cluster barrier in the step),
//   and every warp reduces the 64 slots itself and takes the winner's
//   coordinates from them. Measured
//   beside it (same card): the same exchange across a cluster barrier
//   (~0.9 us a step for the chain alone, against ~0.45), clusters of 4 (as
//   fast at 16,384 rows, with half the rows on chip) and 16, each block
//   first reducing its warps (a block barrier more on the chain: slower),
//   and the long block: one block of 1024 threads, the first 16,384 rows'
//   coordinates in shared memory and their minima in registers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockThreads = 256;                    // block and cluster designs
constexpr int kBlockRows = 8192;                      // the most rows of a one-block set
constexpr int kWarpRows = 256;                        // the most rows of a one-warp set
constexpr int kClusterLong = 8;                       // the long path's cluster size
constexpr int kClusterPer = 16;                       // the most head rows a thread

// (dx*dx + dy*dy) + dz*dz, every operation rounded on its own
__device__ __forceinline__ float sq_dist(float x, float y, float z, float lx, float ly,
                                         float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// order-preserving u32 of a float: every negative float maps below +0.0
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the warp's largest key and, among the lanes holding it, the lowest row
__device__ __forceinline__ void warp_argmax(unsigned& key, int& row) {
  const unsigned mx = __reduce_max_sync(kFull, key);
  row = __reduce_min_sync(kFull, key == mx ? row : INT_MAX);
  key = mx;
}

// The block's argmax from every thread's (key, row), in every thread: W
// warps' results through s_key/s_row[par], one barrier (none for W == 1).
template <int W>
__device__ __forceinline__ int block_argmax(unsigned key, int row, unsigned (*s_key)[W],
                                            int (*s_row)[W], int par) {
  warp_argmax(key, row);
  if (W > 1) {
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      s_key[par][threadIdx.x >> 5] = key;
      s_row[par][threadIdx.x >> 5] = row;
    }
    __syncthreads();
    key = lane < W ? s_key[par][lane] : 0u;
    row = lane < W ? s_row[par][lane] : INT_MAX;
    warp_argmax(key, row);
  }
  return row;
}

// block / warp designs: one block of T threads a set of l <= T * PER rows
template <int T, int PER>
__global__ void __launch_bounds__(T)
fps_block_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
                 int* __restrict__ out, int l, int nsamp) {
  constexpr int W = T / 32;
  extern __shared__ float4 s_pt[];                    // l rows, for the winner's broadcast
  __shared__ unsigned s_key[2][W];
  __shared__ int s_row[2][W];

  const int set = blockIdx.x, t = threadIdx.x;
  const float* p = pts + (size_t)set * l * 3;
  const unsigned char* v = valid + (size_t)set * l;

  float px[PER], py[PER], pz[PER], m[PER];
  int first = l - 1;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = t + k * T;
    px[k] = py[k] = pz[k] = 0.f;
    m[k] = -INFINITY;                                 // a slot past l: never wins
    if (j < l) {
      px[k] = p[(size_t)j * 3 + 0];
      py[k] = p[(size_t)j * 3 + 1];
      pz[k] = p[(size_t)j * 3 + 2];
      s_pt[j] = make_float4(px[k], py[k], pz[k], 0.f);
      const bool ok = v[j] != 0;
      m[k] = ok ? kBig : -kBig;
      if (ok) first = min(first, j);
    }
  }
  if (W == 1) __syncwarp();                           // s_pt to the whole warp
  // the first sample: the lowest valid row, else l - 1 (all keys tie)
  int par = 0;
  int last = block_argmax<W>(0u, first, s_key, s_row, par);

  int* o = out + (size_t)set * nsamp;
  for (int i = 0; i < nsamp; ++i) {
    if (t == 0) o[i] = last;
    const float4 c = s_pt[last];
    float bv = -INFINITY;
    int row = l;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      m[k] = fminf(m[k], sq_dist(px[k], py[k], pz[k], c.x, c.y, c.z));
      if (m[k] > bv) {
        bv = m[k];
        row = t + k * T;
      }
    }
    par ^= 1;
    last = block_argmax<W>(order_key(bv), row, s_key, s_row, par);
  }
}

// Distributed shared memory without a cluster barrier: st.async writes a
// value into another block's shared memory and completes bytes on an
// mbarrier there; the receiver waits for its mbarrier's phase.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned remote(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// arm the mbarrier's current phase: it completes once `bytes` have arrived
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void st_async(unsigned addr, uint4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(unsigned addr, unsigned v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(
                   addr),
               "r"(v), "r"(bar)
               : "memory");
}

// wait for the phase of parity `parity`; traps instead of hanging if the
// bytes never come
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}

constexpr unsigned kEntryBytes = 20;                  // (key, row, x, y) + z

// The warp's winner (largest key, lowest row) in every lane: the entry
// (key, row, x bits, y bits), and its z in `z`.
__device__ __forceinline__ uint4 warp_entry(unsigned key, int row, float x, float y, float& z) {
  unsigned wk = key;
  int wr = row;
  warp_argmax(wk, wr);
  const int src = __ffs(__ballot_sync(kFull, key == wk && row == wr)) - 1;
  z = __shfl_sync(kFull, z, src);
  return make_uint4(wk, (unsigned)wr, __float_as_uint(__shfl_sync(kFull, x, src)),
                    __float_as_uint(__shfl_sync(kFull, y, src)));
}

// The winner of N slot entries e/ez, reduced by the calling warp alone: its
// row, and its coordinates in (lx, ly, lz).
template <int N>
__device__ __forceinline__ int reduce_slots(const uint4* e, const float* ez, float& lx,
                                            float& ly, float& lz) {
  unsigned bk = 0u;
  int br = INT_MAX, be = 0;
  for (int n = threadIdx.x & 31; n < N; n += 32) {
    const uint4 entry = e[n];
    if (entry.x > bk || (entry.x == bk && (int)entry.y < br)) {
      bk = entry.x;
      br = (int)entry.y;
      be = n;
    }
  }
  unsigned ck = bk;
  int cr = br;
  warp_argmax(ck, cr);
  be = __shfl_sync(kFull, be, __ffs(__ballot_sync(kFull, bk == ck && br == cr)) - 1);
  const uint4 entry = e[be];
  lx = __uint_as_float(entry.z);
  ly = __uint_as_float(entry.w);
  lz = ez[be];
  return cr;
}

// The cluster's argmax of every thread's (key, row) with the row's
// coordinates, in every thread of the cluster: lanes 0 .. CS-1 of every
// warp write the warp's winner into the slot arrays s_e/s_z[buf] of the CS
// blocks by st.async; each block waits on its own mbarrier for the
// entries' bytes, then every warp reduces all the slots itself and reads
// the winner's coordinates (lx, ly, lz). `call` counts the exchanges: its
// parity picks the buffer.
template <int CS, int W>
__device__ __forceinline__ int cluster_argmax(cg::cluster_group& cluster,
                                              uint4 (*s_e)[CS * W], float (*s_z)[CS * W],
                                              unsigned long long* mbar, int call,
                                              unsigned key, int row, float x, float y,
                                              float z, float& lx, float& ly, float& lz) {
  const int buf = call & 1;
  const int lane = threadIdx.x & 31;
  const uint4 entry = warp_entry(key, row, x, y, z);
  const unsigned bar = smem_u32(&mbar[buf]);
  if (lane < CS) {
    const int slot = (int)cluster.block_rank() * W + (threadIdx.x >> 5);
    const unsigned rbar = remote(bar, lane);
    st_async(remote(smem_u32(&s_e[buf][slot]), lane), entry, rbar);
    st_async(remote(smem_u32(&s_z[buf][slot]), lane), __float_as_uint(z), rbar);
  }
  mbar_wait(bar, (call >> 1) & 1);
  // arm the buffer's next phase; its bytes can only come after every warp
  // here has sent the next exchange's entry, so after every warp's wait
  if (threadIdx.x == 0) mbar_expect(bar, CS * W * kEntryBytes);
  return reduce_slots<CS * W>(s_e[buf], s_z[buf], lx, ly, lz);
}

// cluster design: CS blocks of kBlockThreads a set of any l; block `rank`
// holds rows rank * T * PER + k * T + t of the head in registers, and tail
// rows head + rank * T + t + n * CS * T
template <int CS, int PER>
__global__ void __launch_bounds__(kBlockThreads)
fps_cluster_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
                   float* __restrict__ tail_mind, int* __restrict__ out, int l, int nsamp) {
  constexpr int T = kBlockThreads, W = T / 32, NE = CS * W;
  constexpr int kHead = CS * T * PER;
  __shared__ uint4 s_e[2][NE];                        // (key, row, x bits, y bits)
  __shared__ float s_z[2][NE];
  __shared__ unsigned long long mbar[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int set = blockIdx.x / CS, t = threadIdx.x;
  const int head = min(l, kHead), tail = l - head;
  const float* p = pts + (size_t)set * l * 3;
  const unsigned char* v = valid + (size_t)set * l;
  float* tm = tail_mind + (size_t)set * tail;
  const int base = rank * T * PER + t;

  float px[PER], py[PER], pz[PER], m[PER];
  int first = l - 1;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = base + k * T;
    px[k] = py[k] = pz[k] = 0.f;
    m[k] = -INFINITY;
    if (j < head) {
      px[k] = p[(size_t)j * 3 + 0];
      py[k] = p[(size_t)j * 3 + 1];
      pz[k] = p[(size_t)j * 3 + 2];
      const bool ok = v[j] != 0;
      m[k] = ok ? kBig : -kBig;
      if (ok) first = min(first, j);
    }
  }
  for (int j = head + rank * T + t; j < l; j += CS * T) {
    const bool ok = v[j] != 0;
    tm[j - head] = ok ? kBig : -kBig;
    if (ok) first = min(first, j);
  }
  if (t == 0) {
    mbar_init(smem_u32(&mbar[0]));
    mbar_init(smem_u32(&mbar[1]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(smem_u32(&mbar[0]), NE * kEntryBytes);
    mbar_expect(smem_u32(&mbar[1]), NE * kEntryBytes);
  }
  // every block of the cluster runs (and has its mbarriers) before any
  // writes its shared memory
  cluster.sync();

  // the first sample: the lowest valid row, else l - 1 (all keys tie); its
  // coordinates from device memory (its holder may be any block)
  float lx, ly, lz;
  int last = cluster_argmax<CS, W>(cluster, s_e, s_z, mbar, 0, 0u, first, 0.f, 0.f, 0.f, lx,
                                   ly, lz);
  lx = p[(size_t)last * 3 + 0];
  ly = p[(size_t)last * 3 + 1];
  lz = p[(size_t)last * 3 + 2];

  int* o = out + (size_t)set * nsamp;
  for (int i = 0; i < nsamp; ++i) {
    if (rank == 0 && t == 0) o[i] = last;
    float bv = -INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
    int row = l;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      m[k] = fminf(m[k], sq_dist(px[k], py[k], pz[k], lx, ly, lz));
      if (m[k] > bv) {
        bv = m[k];
        row = base + k * T;
        bx = px[k];
        by = py[k];
        bz = pz[k];
      }
    }
    for (int j = head + rank * T + t; j < l; j += CS * T) {
      const float* q = p + (size_t)j * 3;
      const float qx = q[0], qy = q[1], qz = q[2];
      const float mm = fminf(tm[j - head], sq_dist(qx, qy, qz, lx, ly, lz));
      tm[j - head] = mm;
      if (mm > bv) {
        bv = mm;
        row = j;
        bx = qx;
        by = qy;
        bz = qz;
      }
    }
    last = cluster_argmax<CS, W>(cluster, s_e, s_z, mbar, i + 1, order_key(bv), row, bx, by,
                                 bz, lx, ly, lz);
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <int T, int PER>
int launch_block(const float* pts, const unsigned char* valid, int* out, int r, int l,
                 int nsamp, cudaStream_t s) {
  const size_t smem = (size_t)l * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(fps_block_kernel<T, PER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_block_kernel<T, PER><<<r, T, smem, s>>>(pts, valid, out, l, nsamp);
  return (int)cudaGetLastError();
}

// rows a thread of a T-thread block for sets of at most kMaxRows rows
constexpr int block_per(int T, int kMaxRows, int per) { return T * per <= kMaxRows ? per : 1; }

// one block of T threads a set of l <= kMaxRows rows, the fewest rows a thread
template <int T, int kMaxRows>
int launch_block_design(const float* pts, const unsigned char* valid, int* out, int r, int l,
                        int nsamp, cudaStream_t s) {
  const int per = pow2_at_least((l + T - 1) / T);
  if (T * per > kMaxRows) return (int)cudaErrorInvalidValue;
  switch (per) {
    case 1: return launch_block<T, 1>(pts, valid, out, r, l, nsamp, s);
    case 2: return launch_block<T, block_per(T, kMaxRows, 2)>(pts, valid, out, r, l, nsamp, s);
    case 4: return launch_block<T, block_per(T, kMaxRows, 4)>(pts, valid, out, r, l, nsamp, s);
    case 8: return launch_block<T, block_per(T, kMaxRows, 8)>(pts, valid, out, r, l, nsamp, s);
    case 16: return launch_block<T, block_per(T, kMaxRows, 16)>(pts, valid, out, r, l, nsamp, s);
    default: return launch_block<T, block_per(T, kMaxRows, 32)>(pts, valid, out, r, l, nsamp, s);
  }
}

// `kernel` on r clusters of CS blocks of kBlockThreads
template <int CS, typename Kernel>
int launch_clusters(Kernel kernel, const float* pts, const unsigned char* valid,
                    float* tail_mind, int* out, int r, int l, int nsamp, cudaStream_t s) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(r * CS);
  config.blockDim = dim3(kBlockThreads);
  config.dynamicSmemBytes = 0;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&config, kernel, pts, valid, tail_mind, out, l, nsamp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int CS, int PER>
int launch_cluster(const float* pts, const unsigned char* valid, float* tail_mind, int* out,
                   int r, int l, int nsamp, cudaStream_t s) {
  return launch_clusters<CS>(fps_cluster_kernel<CS, PER>, pts, valid, tail_mind, out, r, l,
                             nsamp, s);
}

// a cluster of CS blocks a set; the head's rows a thread, at most
// kClusterPer (longer sets stream a tail)
template <int CS>
int launch_cluster_design(const float* pts, const unsigned char* valid, float* tail_mind,
                          int* out, int r, int l, int nsamp, cudaStream_t s) {
  switch (pow2_at_least((l + CS * kBlockThreads - 1) / (CS * kBlockThreads))) {
    case 1: return launch_cluster<CS, 1>(pts, valid, tail_mind, out, r, l, nsamp, s);
    case 2: return launch_cluster<CS, 2>(pts, valid, tail_mind, out, r, l, nsamp, s);
    case 4: return launch_cluster<CS, 4>(pts, valid, tail_mind, out, r, l, nsamp, s);
    case 8: return launch_cluster<CS, 8>(pts, valid, tail_mind, out, r, l, nsamp, s);
    default: return launch_cluster<CS, kClusterPer>(pts, valid, tail_mind, out, r, l, nsamp, s);
  }
}

}  // namespace

// pts (R, L, 3) f32, valid (R, L) bool, out (R, nsamp) int32; L <= 8192
// (see hvpr_fps_long for longer sets): one warp a set up to 256 rows, else
// one block of 256 threads
extern "C" int hvpr_fps_chunks(const float* pts, const unsigned char* valid, int* out, int r,
                               int l, int nsamp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (l <= kWarpRows) return launch_block_design<32, kWarpRows>(pts, valid, out, r, l, nsamp, s);
  return launch_block_design<kBlockThreads, kBlockRows>(pts, valid, out, r, l, nsamp, s);
}

// rows of a set hvpr_fps_long holds on chip; a longer set needs tail_mind of
// R x (L - this) floats
extern "C" int hvpr_fps_long_head() { return kClusterLong * kBlockThreads * kClusterPer; }

// pts (R, L, 3) f32, valid (R, L) bool, out (R, nsamp) int32, any L >= 1;
// tail_mind: R x max(0, L - hvpr_fps_long_head()) f32 scratch
extern "C" int hvpr_fps_long(const float* pts, const unsigned char* valid, float* tail_mind,
                             int* out, int r, int l, int nsamp, void* stream) {
  return launch_cluster_design<kClusterLong>(pts, valid, tail_mind, out, r, l, nsamp,
                                             (cudaStream_t)stream);
}
