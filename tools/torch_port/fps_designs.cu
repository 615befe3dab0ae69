// Designs of kernel K5 (hvpr_tpu_torch/csrc/fps_chunks.cu) that its entry
// points do not take, built beside it for the measurements of
// tools/torch_port/k1_k5_versions.py, and the argmax chain of every design
// alone (no distance work: the chain floor).
//
// Build: nvcc ... -I hvpr_tpu_torch/csrc -o libfps_designs.so fps_designs.cu
// (the tool does). It includes fps_chunks.cu whole, so its kernels, helpers
// and entry points are here too; the designs below reuse them and add:
// - the long block: one block of 1024 threads a set, the first 16,384 rows'
//   coordinates in shared memory and their minima in registers;
// - clusters of 4 and 16 blocks with the entry point's st.async exchange
//   (16 is a non-portable cluster size);
// - two other exchanges between a cluster's blocks: every warp's winner
//   written into each block across a cluster barrier, and each block's
//   winner (after a block barrier) sent by st.async;
// - each design's argmax chain: the same dependent steps, each thread's key
//   a cheap function of the last sample instead of its rows' distances.

#include "fps_chunks.cu"

namespace {

constexpr int kLongThreads = 1024;                    // the long block design
constexpr int kLongPer = 16;                          // its minima a thread
constexpr int kLongHead = kLongThreads * kLongPer;    // rows it holds on chip

// a cheap key that depends on the last sample: the chain's stand-in for a
// step's distances
__device__ __forceinline__ unsigned chain_key(int last, int who) {
  return (unsigned(last) * 2654435761u) ^ (unsigned(who) * 40503u);
}

// long block design: one block of kLongThreads a set of any l
__global__ void __launch_bounds__(kLongThreads, 1)
fps_long_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
                float* __restrict__ tail_mind, int* __restrict__ out, int l, int nsamp) {
  constexpr int W = kLongThreads / 32;
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + kLongHead;
  float* sz = sy + kLongHead;
  __shared__ unsigned s_key[2][W];
  __shared__ int s_row[2][W];

  const int set = blockIdx.x, t = threadIdx.x;
  const int head = min(l, kLongHead), tail = l - head;
  const float* p = pts + (size_t)set * l * 3;
  const unsigned char* v = valid + (size_t)set * l;
  float* tm = tail_mind + (size_t)set * tail;

  float mind[kLongPer];
  int first = l - 1;
#pragma unroll
  for (int k = 0; k < kLongPer; ++k) {
    const int j = t + k * kLongThreads;
    mind[k] = -INFINITY;                              // a slot past the head: never wins
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
  int par = 0;
  int last = block_argmax<W>(0u, first, s_key, s_row, par);

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
    int row = l;
    // rows rise within a thread (the head, then the tail): ties keep the first
#pragma unroll
    for (int k = 0; k < kLongPer; ++k) {
      const int j = t + k * kLongThreads;
      if (j < head) {
        mind[k] = fminf(mind[k], sq_dist(sx[j], sy[j], sz[j], lx, ly, lz));
        if (mind[k] > bv) {
          bv = mind[k];
          row = j;
        }
      }
    }
    for (int j = head + t; j < l; j += kLongThreads) {
      const float* q = p + (size_t)j * 3;
      const float mm = fminf(tm[j - head], sq_dist(q[0], q[1], q[2], lx, ly, lz));
      tm[j - head] = mm;
      if (mm > bv) {
        bv = mm;
        row = j;
      }
    }
    par ^= 1;
    last = block_argmax<W>(order_key(bv), row, s_key, s_row, par);
  }
}

// the argmax chain of a block of T threads (the block, warp and long block
// designs): nsamp dependent block_argmax steps, no distance work
template <int T>
__global__ void __launch_bounds__(T) block_chain_kernel(int* __restrict__ out, int nsamp) {
  constexpr int W = T / 32;
  __shared__ unsigned s_key[2][W];
  __shared__ int s_row[2][W];
  const int t = threadIdx.x;
  int par = 0;
  int last = block_argmax<W>(0u, t, s_key, s_row, par);
  int* o = out + (size_t)blockIdx.x * nsamp;
  for (int i = 0; i < nsamp; ++i) {
    if (t == 0) o[i] = last;
    par ^= 1;
    last = block_argmax<W>(chain_key(last, t), t, s_key, s_row, par);
  }
}

// How the blocks of a cluster exchange a step's winners.
enum Exchange {
  kWarpsTx = 0,       // each warp's winner into every block's slots by st.async (the entry point's)
  kWarpsBarrier = 1,  // each warp's winner into every block's slots, a cluster barrier
  kBlockTx = 2,       // the block's winner (one block barrier) by st.async
};

// cluster_argmax of fps_chunks.cu with the exchange kX: kWarpsTx is that
// function; kWarpsBarrier writes the warp's entry into the CS blocks' slots
// and crosses a cluster barrier; kBlockTx first reduces the block's warps
// through s_w/s_wz (one block barrier), then lanes 0 .. CS-1 of warp 0 send
// the block's winner by st.async.
template <int CS, int W, int kX>
__device__ __forceinline__ int exchange(cg::cluster_group& cluster, uint4 (*s_e)[CS * W],
                                        float (*s_z)[CS * W], uint4 (*s_w)[W],
                                        float (*s_wz)[W], unsigned long long* mbar, int call,
                                        unsigned key, int row, float x, float y, float z,
                                        float& lx, float& ly, float& lz) {
  if constexpr (kX == kWarpsTx) {
    return cluster_argmax<CS, W>(cluster, s_e, s_z, mbar, call, key, row, x, y, z, lx, ly, lz);
  } else {
    const int buf = call & 1, rank = (int)cluster.block_rank();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint4 entry = warp_entry(key, row, x, y, z);
    if constexpr (kX == kWarpsBarrier) {
      if (lane < CS) {
        *cluster.map_shared_rank(&s_e[buf][rank * W + warp], lane) = entry;
        *cluster.map_shared_rank(&s_z[buf][rank * W + warp], lane) = z;
      }
      cluster.sync();
      return reduce_slots<CS * W>(s_e[buf], s_z[buf], lx, ly, lz);
    } else {
      const unsigned bar = smem_u32(&mbar[buf]);
      if (lane == 0) {
        s_w[buf][warp] = entry;
        s_wz[buf][warp] = z;
      }
      __syncthreads();
      if (warp == 0) {
        unsigned bk = lane < W ? s_w[buf][lane].x : 0u;
        int br = lane < W ? (int)s_w[buf][lane].y : INT_MAX;
        const unsigned k0 = bk;
        const int r0 = br;
        warp_argmax(bk, br);
        const int w = __ffs(__ballot_sync(kFull, k0 == bk && r0 == br)) - 1;
        if (lane < CS) {
          const unsigned rbar = remote(bar, lane);
          st_async(remote(smem_u32(&s_e[buf][rank]), lane), s_w[buf][w], rbar);
          st_async(remote(smem_u32(&s_z[buf][rank]), lane), __float_as_uint(s_wz[buf][w]),
                   rbar);
        }
      }
      mbar_wait(bar, (call >> 1) & 1);
      if (threadIdx.x == 0) mbar_expect(bar, CS * kEntryBytes);
      return reduce_slots<CS>(s_e[buf], s_z[buf], lx, ly, lz);
    }
  }
}

// fps_cluster_kernel of fps_chunks.cu with the exchange kX, or (kChain) its
// argmax chain alone
template <int CS, int PER, int kX, bool kChain>
__global__ void __launch_bounds__(kBlockThreads)
fps_cluster_x_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
                     float* __restrict__ tail_mind, int* __restrict__ out, int l, int nsamp) {
  constexpr int T = kBlockThreads, W = T / 32, NE = CS * W;
  constexpr int kHead = CS * T * PER;
  __shared__ uint4 s_e[2][NE];                        // (key, row, x bits, y bits)
  __shared__ float s_z[2][NE];
  __shared__ uint4 s_w[2][W];                         // kBlockTx: the warps' winners
  __shared__ float s_wz[2][W];
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
  if (kX != kWarpsBarrier && t == 0) {
    const unsigned bytes = (kX == kBlockTx ? CS : NE) * kEntryBytes;
    mbar_init(smem_u32(&mbar[0]));
    mbar_init(smem_u32(&mbar[1]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(smem_u32(&mbar[0]), bytes);
    mbar_expect(smem_u32(&mbar[1]), bytes);
  }
  cluster.sync();

  float lx, ly, lz;
  int last = exchange<CS, W, kX>(cluster, s_e, s_z, s_w, s_wz, mbar, 0, 0u, first, 0.f, 0.f,
                                 0.f, lx, ly, lz);
  lx = p[(size_t)last * 3 + 0];
  ly = p[(size_t)last * 3 + 1];
  lz = p[(size_t)last * 3 + 2];

  int* o = out + (size_t)set * nsamp;
  for (int i = 0; i < nsamp; ++i) {
    if (rank == 0 && t == 0) o[i] = last;
    unsigned key;
    int row;
    float bx = 0.f, by = 0.f, bz = 0.f;
    if (kChain) {
      key = chain_key(last, rank * T + t);
      row = rank * T + t;
    } else {
      float bv = -INFINITY;
      row = l;
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
      key = order_key(bv);
    }
    last = exchange<CS, W, kX>(cluster, s_e, s_z, s_w, s_wz, mbar, i + 1, key, row, bx, by, bz,
                               lx, ly, lz);
  }
  cluster.sync();
}

int launch_long_block(const float* pts, const unsigned char* valid, float* tail_mind, int* out,
                      int r, int l, int nsamp, cudaStream_t s) {
  const size_t smem = (size_t)3 * kLongHead * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_long_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_long_kernel<<<r, kLongThreads, smem, s>>>(pts, valid, tail_mind, out, l, nsamp);
  return (int)cudaGetLastError();
}

template <int T>
int launch_block_chain(int* out, int r, int nsamp, cudaStream_t s) {
  block_chain_kernel<T><<<r, T, 0, s>>>(out, nsamp);
  return (int)cudaGetLastError();
}

// a cluster of CS blocks a set exchanging by kX, or its chain: the entry
// point's kernel for kWarpsTx, else fps_cluster_x_kernel
template <int CS, int PER, int kX, bool kChain>
int launch_x(const float* pts, const unsigned char* valid, float* tail_mind, int* out, int r,
             int l, int nsamp, cudaStream_t s) {
  auto kernel = fps_cluster_x_kernel<CS, PER, kX, kChain>;
  if constexpr (kX == kWarpsTx && !kChain) kernel = fps_cluster_kernel<CS, PER>;
  if (CS > 8) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  return launch_clusters<CS>(kernel, pts, valid, tail_mind, out, r, l, nsamp, s);
}

template <int CS, int kX, bool kChain>
int launch_x_design(const float* pts, const unsigned char* valid, float* tail_mind, int* out,
                    int r, int l, int nsamp, cudaStream_t s) {
  switch (pow2_at_least((l + CS * kBlockThreads - 1) / (CS * kBlockThreads))) {
    case 1: return launch_x<CS, 1, kX, kChain>(pts, valid, tail_mind, out, r, l, nsamp, s);
    case 2: return launch_x<CS, 2, kX, kChain>(pts, valid, tail_mind, out, r, l, nsamp, s);
    case 4: return launch_x<CS, 4, kX, kChain>(pts, valid, tail_mind, out, r, l, nsamp, s);
    case 8: return launch_x<CS, 8, kX, kChain>(pts, valid, tail_mind, out, r, l, nsamp, s);
    default:
      return launch_x<CS, kClusterPer, kX, kChain>(pts, valid, tail_mind, out, r, l, nsamp, s);
  }
}

template <bool kChain>
int run_cluster(int design, const float* pts, const unsigned char* valid, float* tail_mind,
                int* out, int r, int l, int nsamp, cudaStream_t s) {
  switch (design) {
    case 4:  // cluster of 8, every warp's winner to each block, a cluster barrier
      return launch_x_design<8, kWarpsBarrier, kChain>(pts, valid, tail_mind, out, r, l, nsamp,
                                                       s);
    case 5:  // clusters of 4, 8 (the long path's choice) and 16, by st.async
      return launch_x_design<4, kWarpsTx, kChain>(pts, valid, tail_mind, out, r, l, nsamp, s);
    case 6: return launch_x_design<8, kWarpsTx, kChain>(pts, valid, tail_mind, out, r, l, nsamp, s);
    case 7:
      return launch_x_design<16, kWarpsTx, kChain>(pts, valid, tail_mind, out, r, l, nsamp, s);
    case 8:  // cluster of 8, each block's winner (a block barrier more), by st.async
      return launch_x_design<8, kBlockTx, kChain>(pts, valid, tail_mind, out, r, l, nsamp, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Run design `design` (0-8 below); chain != 0 runs its argmax chain alone.
// pts (R, L, 3) f32, valid (R, L) bool, out (R, nsamp) int32, tail_mind R x L
// f32 scratch; the blocks take L <= 8192, the warp L <= 256.
extern "C" int hvpr_fps_design(int design, int chain, const float* pts,
                               const unsigned char* valid, float* tail_mind, int* out, int r,
                               int l, int nsamp, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (design) {
    case 0:  // block of 256 threads (the entry point's choice above 256 rows)
      return chain ? launch_block_chain<kBlockThreads>(out, r, nsamp, s)
                   : launch_block_design<kBlockThreads, kBlockRows>(pts, valid, out, r, l,
                                                                    nsamp, s);
    case 1:  // one warp (the entry point's choice up to 256 rows)
      return chain ? launch_block_chain<32>(out, r, nsamp, s)
                   : launch_block_design<32, kWarpRows>(pts, valid, out, r, l, nsamp, s);
    case 2:  // block of 1024 threads
      return chain ? launch_block_chain<1024>(out, r, nsamp, s)
                   : launch_block_design<1024, kBlockRows>(pts, valid, out, r, l, nsamp, s);
    case 3:  // long block (its chain is the block of 1024's)
      return chain ? launch_block_chain<kLongThreads>(out, r, nsamp, s)
                   : launch_long_block(pts, valid, tail_mind, out, r, l, nsamp, s);
    default:
      return chain ? run_cluster<true>(design, pts, valid, tail_mind, out, r, l, nsamp, s)
                   : run_cluster<false>(design, pts, valid, tail_mind, out, r, l, nsamp, s);
  }
}
