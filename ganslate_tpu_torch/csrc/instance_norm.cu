// Fused instance norm (+ ReLU / LeakyReLU) forward and backward for Hopper
// (sm_90a).
//
// x is the contiguous (N, S, C) view of a channels-last (N, *spatial, C)
// tensor, the layout the JAX package's Pallas kernels see. Statistics are
// fp32 (mean and biased variance per sample and channel), y = act((x - mean)
// * rstd) is cast back to x's dtype (float or bfloat16), and the fp32 mean
// and rstd = 1 / sqrt(var + eps) of shape (N, C) are returned beside it.
//
// Kernels and the TPU kernels they replace (ganslate_tpu/ops/instance_norm.py):
//   inorm_onepass_kernel      _pallas_forward (pallas_call at :85)
//   inorm_split_stats_kernel  _pallas_forward_tiled, stats_kernel (:122-135, pallas_call
//                             at :137) and the stats fold in XLA (:148-151)
//   inorm_split_norm_kernel   _pallas_forward_tiled, norm_kernel (:153-156, pallas_call at :160)
//
// Bound on an H100 SXM (3.35 TB/s HBM3): the op must read x once and write y
// once, 2 * N*S*C*itemsize bytes; e.g. bf16 (16, 64*64, 256) moves 67 MB,
// 20 us. The arithmetic (about 6 fp32 operations per element) is far below
// the card's rate, so the bytes bound it.
//
// One-pass design: a thread-block cluster. A block owns a tile of rows x G
// channels of one sample, and reads each row segment of G * itemsize bytes
// (32, 64 or 128) as 16-byte vectors of neighbouring threads, so every
// access moves whole 32-byte sectors. The K blocks along the rows of one
// (sample, channel group) form a cluster of (K, 1, 1) on a grid of
// (K * C / G, N). Each block copies its rows into shared memory with
// cp.async (all of them in flight at once, x read from device memory once),
// takes its local mean and then its M2 around that mean from shared memory,
// and publishes (mean, M2). After a cluster barrier every block reads the K
// partials through distributed shared memory and merges them in rank order
// with Chan's formula (the split form's fold): deterministic, no atomics,
// exact where E[x^2] - E[x]^2 cancels, and the same in every block. It then
// normalises its rows from shared memory and writes y once; rank 0 writes
// mean and rstd. A second cluster barrier, arrived at after the merge and
// waited on before exit, keeps each block's partials alive while a peer may
// still read them.
//
// G and K come from the caller (ops/instance_norm.py:onepass_geometry), whose
// rule was picked from chip_smoke.py's timings of every (G, K) at the main
// slabs (PERF.md; two runs on an H100 80GB HBM3, 700 W): 64-byte segments,
// K <= 8, at most 64 KB per block (3 blocks per SM), at least 64 blocks.
// bf16 (16, 4096, 256) takes G = 32, K = 4: 512 blocks, 0.0363-0.0365 ms.
// 128-byte segments need twice the cluster for the same block, and were no
// faster (G = 64, K = 8: 0.0366-0.0367 ms); K = 16 took 0.045-0.058 ms, and
// 32-byte segments 0.042-0.095 ms. At batch 1, bf16 (1, 4096, 256) takes
// G = 32, K = 8: 64 blocks, 0.0083-0.0084 ms, where 32 blocks took
// 0.0087 ms and 128 blocks 0.0106 ms.
//
// This answers the three limits of the earlier one-pass kernel, which kept a
// whole (S, 16 bf16) column slab per block: it read 32 bytes out of every
// 512-byte row (now 64; the wider 128 was no faster, above); its 128 KB
// slab allowed one block per SM, so load, reduce and
// store ran strictly in turn (now 64 KB or less per block, 3 per SM, whose
// phases overlap); and batch 1 had 16 blocks for 132 SMs (now 64).
//
// Split design, for slabs too large for one cluster's shared memory: two
// kernels over whole-row tiles. A tile is R consecutive rows x one row
// segment of one sample; the segment is the whole row (C * itemsize bytes)
// up to 512 bytes, so a tile is one contiguous span of device memory and no
// 128-byte line is shared between blocks. (Wider rows are cut into segments
// of at most 512 bytes, one more factor of the grid, so that a block's
// channels and its per-thread accumulators stay bounded.) Each thread keeps
// one fixed 16-byte vector column of the segment, so it always holds the
// same channels; the thread count is a multiple of the vectors per segment
// (e.g. 192 threads for a 96-byte row of 48 bf16 channels).
//
// - inorm_split_stats_kernel brings its tile into shared memory with one
//   asynchronous bulk copy (cp.async.bulk, completing on an mbarrier; a
//   contiguous span needs no TMA tensor map; a segmented row takes one copy
//   per row), and several blocks per SM keep their copies in flight. From
//   shared memory it takes the tile's mean, then its M2 around that mean,
//   and writes (mean, M2) to a (N, tiles, 2, C) scratch. The Chan fold runs
//   inside the kernel, in two levels of fixed order: each block fences and
//   counts itself on its group's arrival counter (an int atomic, not a
//   statistic); the last of a group of 16 tiles to arrive merges the
//   group's partials in tile order with Chan's formula, then counts the
//   group on the sample's counter; the last group to arrive merges the
//   groups in order and writes mean and rstd. So the result does not
//   depend on the schedule: deterministic, exact where E[x^2] - E[x]^2
//   cancels (|mean| >> std), and no fold launch between the passes. (One
//   chain over a sample's 256-512 tiles waited for L2 at every step: 0.24
//   us a tile, PERF.md; two short chains, their loads batched, replace it.)
//   Each merging block resets
//   its counter to zero, so the counters are zero between launches; the
//   caller keeps one counter buffer per stream
//   (ops/instance_norm.py:_arrivals).
// - inorm_split_norm_kernel reads x again with 16-byte loads of the same
//   tiles, several in flight per thread, and writes y once. Each thread
//   loads its channels' mean and rstd once. It may walk the tiles in the
//   reverse of the stats pass's order, so that it starts on the bytes that
//   pass read last, which may still be in the 50 MB L2 (at batch 1 a whole
//   slab fits it).
//
// The split form moves 1.5x the bound's bytes (x read twice); it is bound
// by device memory. R, the segment and the thread count come from the
// caller (ops/instance_norm.py:split_geometry), whose rule was picked from
// chip_smoke.py's timings at the four split slabs (PERF.md).
//
// Backward. The kernels norm_bwd_* replace no TPU kernel: the JAX package's
// gradient (_bwd in ganslate_tpu/ops/instance_norm.py) is XLA, and the plain
// version (instance_norm_backward) makes a dozen fp32 passes over the slab.
// From the saved x, mean and rstd and the output's gradient g, per (sample,
// channel) over S rows:
// y = (x - mean) * rstd (fp32), g' = g * act'(y) (the kinks of _act_grad),
// the sums of g' and g' * y in fp32, and dx = rstd * (g' - sum(g') / S -
// y * sum(g' y) / S), written once in x's dtype. The names leave out
// "inorm", which the benchmark reads as the forward's kernels.
//
// Bound: x and g read once, dx written once: 3 slab-sized transfers
// (bf16 (16, 256*256, 64): 403 MB, 0.120 ms at 3.35 TB/s). The arithmetic
// (about 12 fp32 operations per element) is far below the card's rate.
// - norm_bwd_onepass_kernel, for the slabs the forward's one-pass form
//   takes: the forward's cluster, with x's and g's rows both in shared
//   memory (twice the forward's bytes per block, so the caller's
//   ops/instance_norm.py:backward_onepass_geometry keeps its own rule).
//   The blocks add their sums through distributed shared memory in rank
//   order and write dx from shared memory: the 3 transfers of the bound.
// - the split pair, for larger slabs, at the forward's split tiles:
//   norm_bwd_sums_kernel brings the tiles of x and g in by bulk copies and
//   folds the tiles' sums in tile order on the arrival counters (no float
//   atomics: dx has the same bits from run to run); norm_bwd_dx_kernel
//   reads both tiles again, in reverse order so that it starts on what may
//   still be in L2, and writes dx. That is 5 transfers, 1.67x the bound,
//   less what L2 keeps. A spatially sharded slab takes the pair whatever
//   its size: its sums are added over the shards between the two kernels.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kVecBytes = 16;                 // one vector access
constexpr int kOnepassThreads = 256;
constexpr int kMaxCluster = 16;               // above 8 needs the non-portable attribute
constexpr int kSplitMaxThreads = 512;
constexpr int kSplitMaxVecs = 32;             // split form: a row segment is at most 512 bytes
constexpr int kSplitUnroll = 4;               // split normalise: loads in flight per thread
constexpr int kFoldGroup = 16;                // split fold: tiles merged per group
constexpr int kFoldBatch = 8;                 // split fold: partials loaded per trip
constexpr int kMaxSmem = 227 * 1024;          // shared memory a Hopper block may use

enum Activation { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

// Unpacks one 16-byte vector into fp32 values and packs it back.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  // bf16 is the high half of a float: widening is exact.
  __device__ static void unpack2(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  // Round to nearest even, as the JAX package's astype(bfloat16).
  __device__ static uint32_t pack2(float a, float b) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
  }
  __device__ static void unpack(const uint4& v, float* f) {
    unpack2(v.x, f); unpack2(v.y, f + 2); unpack2(v.z, f + 4); unpack2(v.w, f + 6);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

__device__ __forceinline__ float activate(float y, int act, float slope) {
  if (act == kRelu) return fmaxf(y, 0.f);
  if (act == kLeakyRelu) return y >= 0.f ? y : y * slope;
  return y;
}

// Sums v over the block's threads that share a vector column (threadIdx.x %
// kCols) and writes total / divisor for each of the block's kCols * kN
// channels to out. red holds kThreads / 32 * kCols * kN floats. Ends with a
// barrier, so out is visible to every thread on return.
template <int kN, int kThreads, int kCols>
__device__ void block_sum(float (&v)[kN], float* red, float* out, float divisor) {
#pragma unroll
  for (int off = 16; off >= kCols; off >>= 1)
#pragma unroll
    for (int j = 0; j < kN; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < kCols)
#pragma unroll
    for (int j = 0; j < kN; ++j) red[(warp * kCols + lane) * kN + j] = v[j];
  __syncthreads();
  if (threadIdx.x < kCols * kN) {
    const int col = threadIdx.x / kN, e = threadIdx.x % kN;
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[(w * kCols + col) * kN + e];
    out[threadIdx.x] = s / divisor;
  }
  __syncthreads();
}

// ------------------------------------------------------------ one-pass form

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(gmem) : "memory");
}

// Waits for this thread's cp.async copies; they are then visible to it.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The two halves of a cluster barrier (arrive releases, wait acquires).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// First row of rank r when S rows are split over k ranks as evenly as
// possible: rank r owns rows [rank_row(r), rank_row(r + 1)), at least one
// when k <= S.
__device__ __forceinline__ int rank_row(int r, int S, int k) {
  return static_cast<int>(static_cast<long long>(r) * S / k);
}

// One block: rows [rank_row(rank), rank_row(rank + 1)) x kG channels of one
// sample, row segments of kCols 16-byte vectors. Every thread keeps one
// vector column and visits the rows it copied, so the slab needs no barrier
// between the copy and the first reading pass.
template <typename T, int kCols>
__global__ void __launch_bounds__(kOnepassThreads)
inorm_onepass_kernel(const T* __restrict__ x, T* __restrict__ y,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out,
                     int S, int C, float eps, int act, float slope) {
  using V = Vec<T>;
  constexpr int kN = V::kN, kG = kCols * kN, kStep = kOnepassThreads / kCols;
  extern __shared__ uint4 slab[];                  // rows x kCols vectors
  __shared__ float red[kOnepassThreads / 32 * kG];
  __shared__ float s_part[2 * kG];                 // local mean, M2: read by the peers
  __shared__ float s_mean[kG], s_rstd[kG];

  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = blockIdx.x / k, n = blockIdx.y, col = threadIdx.x % kCols;
  const int r0 = rank_row(rank, S, k), rows = rank_row(rank + 1, S, k) - r0;
  const size_t base = (static_cast<size_t>(n) * S + r0) * C + group * kG + col * kN;

  for (int r = threadIdx.x / kCols; r < rows; r += kStep)
    cp_async_16(slab + r * kCols + col, x + base + static_cast<size_t>(r) * C);
  cp_async_wait_all();

  float acc[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int r = threadIdx.x / kCols; r < rows; r += kStep) {
    float f[kN];
    V::unpack(slab[r * kCols + col], f);
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[j] += f[j];
  }
  block_sum<kN, kOnepassThreads, kCols>(acc, red, s_part, static_cast<float>(rows));

  float mu[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) { mu[j] = s_part[col * kN + j]; acc[j] = 0.f; }
#pragma unroll 4
  for (int r = threadIdx.x / kCols; r < rows; r += kStep) {
    float f[kN];
    V::unpack(slab[r * kCols + col], f);
#pragma unroll
    for (int j = 0; j < kN; ++j) { const float d = f[j] - mu[j]; acc[j] += d * d; }
  }
  block_sum<kN, kOnepassThreads, kCols>(acc, red, s_part + kG, 1.f);

  // Every rank's partials are published; merge them in rank order through
  // distributed shared memory (Chan et al., as the split form's fold).
  // All k remote loads are issued before the first is used, so the merge
  // waits for one distributed-shared-memory round trip, not k.
  cluster.sync();
  if (threadIdx.x < kG) {
    float mb[kMaxCluster], m2b[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < k) {
        const float* p = cluster.map_shared_rank(&s_part[0], r);
        mb[r] = p[threadIdx.x];
        m2b[r] = p[kG + threadIdx.x];
      }
    }
    float count = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < k) {
        const float nb = static_cast<float>(rank_row(r + 1, S, k) - rank_row(r, S, k));
        const float total = count + nb;
        const float d = mb[r] - mean;
        mean += d * (nb / total);
        m2 += m2b[r] + d * d * (count * nb / total);
        count = total;
      }
    }
    const float rstd = 1.f / sqrtf(m2 / S + eps);
    s_mean[threadIdx.x] = mean;
    s_rstd[threadIdx.x] = rstd;
    if (rank == 0) {
      const int c = n * C + group * kG + threadIdx.x;
      mean_out[c] = mean;
      rstd_out[c] = rstd;
    }
  }
  cluster_arrive();                                // done reading the peers
  __syncthreads();

  float rs[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) { mu[j] = s_mean[col * kN + j]; rs[j] = s_rstd[col * kN + j]; }
#pragma unroll 4
  for (int r = threadIdx.x / kCols; r < rows; r += kStep) {
    float f[kN];
    V::unpack(slab[r * kCols + col], f);
#pragma unroll
    for (int j = 0; j < kN; ++j) f[j] = activate((f[j] - mu[j]) * rs[j], act, slope);
    *reinterpret_cast<uint4*>(y + base + static_cast<size_t>(r) * C) = V::pack(f);
  }
  cluster_wait();                                  // no peer still reads s_part
}

// --------------------------------------------------------------- split form

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier for one arrival, made visible to the asynchronous proxy that
// completes the bulk copies' transactions on it.
__device__ __forceinline__ void mbarrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(1u) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Arrives on bar and announces `bytes` of copies that will complete on it.
__device__ __forceinline__ void mbarrier_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits until bar's phase of the given parity has completed; the copies'
// bytes are then visible to the waiting thread. A copy that never completes
// (a fault, not a case the launcher lets through) ends the kernel with an
// error after about 2^24 tries rather than hanging the card.
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  unsigned done;
  for (unsigned tries = 0;; ++tries) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.b32 %0, 1, 0, p;\n\t}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// One asynchronous bulk copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from device memory into shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The tile of block b. Blocks are numbered by sample, then tile, then row
// segment, so that consecutive blocks cover consecutive bytes.
struct SplitTile {
  int n, t, seg, r0, rows;
};

__device__ __forceinline__ SplitTile split_tile(int b, int S, int R, int n_tiles, int nseg) {
  SplitTile u;
  u.seg = b % nseg;
  u.t = (b / nseg) % n_tiles;
  u.n = b / (nseg * n_tiles);
  u.r0 = u.t * R;
  u.rows = min(R, S - u.r0);
  return u;
}

// Sums v over the block's threads that share a vector column (threadIdx.x %
// vecs) and writes total / divisor for each of the vecs * kN channels to
// out. Where vecs divides a warp, the lanes of one column are summed by
// shuffles first and red holds blockDim.x / 32 * vecs * kN floats; else red
// holds blockDim.x * kN. The order is fixed. Ends with a barrier, so out is
// visible to every thread on return.
template <int kN>
__device__ void column_sum(float (&v)[kN], int vecs, float* red, float* out, float divisor) {
  const int width = vecs * kN;
  int groups;
  if (32 % vecs == 0) {
    for (int off = 16; off >= vecs; off >>= 1)
#pragma unroll
      for (int j = 0; j < kN; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
    const int lane = threadIdx.x & 31;
    if (lane < vecs)
#pragma unroll
      for (int j = 0; j < kN; ++j) red[(threadIdx.x >> 5) * width + lane * kN + j] = v[j];
    groups = blockDim.x >> 5;
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      red[(threadIdx.x / vecs) * width + (threadIdx.x % vecs) * kN + j] = v[j];
    groups = blockDim.x / vecs;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += red[g * width + i];
    out[i] = s / divisor;
  }
  __syncthreads();
}

// Chan et al.'s merge into (count, mean, m2), in order, of partials [lo, hi):
// partial i has its mean at p[i * stride], its M2 at p[i * stride + C] and
// rows_of(i) rows. The loads of kFoldBatch partials are issued before any
// of them is merged, so a batch waits for one trip to L2, not kFoldBatch.
template <typename Rows>
__device__ void chan_fold(const float* p, size_t stride, int C, int lo, int hi, Rows rows_of,
                          float& count, float& mean, float& m2) {
  for (int i0 = lo; i0 < hi; i0 += kFoldBatch) {
    float mb[kFoldBatch], m2b[kFoldBatch];
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) {
      if (i0 + k < hi) {
        mb[k] = __ldcg(p + static_cast<size_t>(i0 + k) * stride);
        m2b[k] = __ldcg(p + static_cast<size_t>(i0 + k) * stride + C);
      }
    }
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) {
      if (i0 + k < hi) {
        const float nb = static_cast<float>(rows_of(i0 + k));
        const float total = count + nb;
        const float d = mb[k] - mean;
        mean += d * (nb / total);
        m2 += m2b[k] + d * d * (count * nb / total);
        count = total;
      }
    }
  }
}

// One block per tile of R rows x vecs vectors. partial is (N, n_tiles, 2, C)
// fp32: each tile's mean, then its M2. The fold runs in two levels, each in
// order: the last tile of each group of kFoldGroup tiles to arrive merges
// the group's partials in tile order and writes the group's (mean, M2) over
// its first tile's; the last group of the sample to arrive merges the
// groups in order and writes mean and rstd, or, with m2_out, mean and the
// slab's M2 in place of rstd: a spatially sharded tensor's slab, whose
// (count, mean, M2) the caller merges with the other shards' (Chan) before
// the normalise kernel runs. (M2 cannot be recovered from rsqrt(var + eps)
// where var << eps.) arrivals holds, per (sample, segment), one counter per group and one for the
// sample, at [(n * nseg + seg) * (n_groups + 1)]: zero on entry, and reset
// to zero by the block that merges.
template <typename T>
__global__ void __launch_bounds__(kSplitMaxThreads)
inorm_split_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                         int* __restrict__ arrivals, float* __restrict__ mean_out,
                         float* __restrict__ rstd_out, int S, int C, int vecs, int R,
                         float eps, int m2_out) {
  using V = Vec<T>;
  constexpr int kN = V::kN;
  extern __shared__ uint4 tile[];                  // R x vecs vectors, then red
  __shared__ uint64_t bar;
  __shared__ float s_mean[kSplitMaxVecs * kN], s_m2[kSplitMaxVecs * kN];
  __shared__ int s_last;

  // Every block has started: the normalise kernel, launched as this one's
  // programmatic dependent, may be scheduled (it waits for this grid's end
  // before it reads the statistics).
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int width = vecs * kN, nseg = C / width, n_tiles = (S + R - 1) / R;
  const SplitTile u = split_tile(blockIdx.x, S, R, n_tiles, nseg);
  const T* src = x + (static_cast<size_t>(u.n) * S + u.r0) * C + u.seg * width;
  float* red = reinterpret_cast<float*>(tile + static_cast<size_t>(R) * vecs);

  // Warp 0 brings the tile in: one bulk copy of the contiguous span, or one
  // per row where the row is cut into segments.
  if (threadIdx.x == 0) mbarrier_init(&bar);
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned seg_bytes = static_cast<unsigned>(vecs * kVecBytes);
    if (threadIdx.x == 0) mbarrier_arrive_expect_tx(&bar, u.rows * seg_bytes);
    __syncwarp();
    if (nseg == 1) {
      if (threadIdx.x == 0) bulk_load(tile, src, u.rows * seg_bytes, &bar);
    } else {
      for (int r = threadIdx.x; r < u.rows; r += 32)
        bulk_load(tile + r * vecs, src + static_cast<size_t>(r) * C, seg_bytes, &bar);
    }
  }
  mbarrier_wait(&bar, 0);

  // The tile's mean, then its M2 around that mean, from shared memory.
  const int col = threadIdx.x % vecs, step = blockDim.x / vecs;
  float acc[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int r = threadIdx.x / vecs; r < u.rows; r += step) {
    float f[kN];
    V::unpack(tile[r * vecs + col], f);
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[j] += f[j];
  }
  column_sum<kN>(acc, vecs, red, s_mean, static_cast<float>(u.rows));
  float mu[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) { mu[j] = s_mean[col * kN + j]; acc[j] = 0.f; }
#pragma unroll 4
  for (int r = threadIdx.x / vecs; r < u.rows; r += step) {
    float f[kN];
    V::unpack(tile[r * vecs + col], f);
#pragma unroll
    for (int j = 0; j < kN; ++j) { const float d = f[j] - mu[j]; acc[j] += d * d; }
  }
  column_sum<kN>(acc, vecs, red, s_m2, 1.f);

  // Publish (mean, M2), then count this tile in its group.
  const size_t stride = 2 * static_cast<size_t>(C);
  float* p = partial + static_cast<size_t>(u.n) * n_tiles * stride + u.seg * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    p[u.t * stride + i] = s_mean[i];
    p[u.t * stride + C + i] = s_m2[i];
  }
  const int n_groups = (n_tiles + kFoldGroup - 1) / kFoldGroup, g = u.t / kFoldGroup;
  const int g0 = g * kFoldGroup, g1 = min(g0 + kFoldGroup, n_tiles);
  int* arrival = arrivals + (u.n * nseg + u.seg) * (n_groups + 1);
  if (threadIdx.x < width) __threadfence();        // the writers' stores, before the count
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrival + g, 1) == g1 - g0 - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The group's last tile: merge its tiles in order, over the first tile's
  // partial (each thread reads and writes only its own channel).
  const auto tile_rows = [=](int t) { return min(R, S - t * R); };
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    float count = 0.f, mean = 0.f, m2 = 0.f;
    chan_fold(p + i, stride, C, g0, g1, tile_rows, count, mean, m2);
    p[g0 * stride + i] = mean;
    p[g0 * stride + C + i] = m2;
  }
  if (threadIdx.x == 0) arrival[g] = 0;
  if (threadIdx.x < width) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrival + n_groups, 1) == n_groups - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The sample's last group: merge the groups in order.
  const int group_rows = kFoldGroup * R;
  const auto rows_of_group = [=](int k) { return min(group_rows, S - k * group_rows); };
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    float count = 0.f, mean = 0.f, m2 = 0.f;
    chan_fold(p + i, kFoldGroup * stride, C, 0, n_groups, rows_of_group, count, mean, m2);
    const int c = u.n * C + u.seg * width + i;
    mean_out[c] = mean;
    rstd_out[c] = m2_out ? m2 : 1.f / sqrtf(m2 / S + eps);
  }
  if (threadIdx.x == 0) arrival[n_groups] = 0;
}

// One block per tile, as the stats kernel's tiles; walks them in reverse
// block order when `reverse` is set.
template <typename T>
__global__ void __launch_bounds__(kSplitMaxThreads)
inorm_split_norm_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                        const float* __restrict__ rstd, T* __restrict__ y, int S, int C,
                        int vecs, int R, int reverse, int act, float slope) {
  using V = Vec<T>;
  constexpr int kN = V::kN;
  const int width = vecs * kN, nseg = C / width, n_tiles = (S + R - 1) / R;
  const int b = reverse ? static_cast<int>(gridDim.x - 1 - blockIdx.x)
                        : static_cast<int>(blockIdx.x);
  const SplitTile u = split_tile(b, S, R, n_tiles, nseg);
  const int col = threadIdx.x % vecs, step = blockDim.x / vecs;
  const int c0 = u.n * C + u.seg * width + col * kN;
  // Launched as the stats kernel's programmatic dependent: wait until that
  // grid has ended and its statistics are visible (no wait otherwise).
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float mu[kN], rs[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) { mu[j] = __ldg(mean + c0 + j); rs[j] = __ldg(rstd + c0 + j); }

  const size_t base = (static_cast<size_t>(u.n) * S + u.r0) * C + u.seg * width + col * kN;
  for (int r = threadIdx.x / vecs; r < u.rows; r += kSplitUnroll * step) {
    uint4 v[kSplitUnroll];
#pragma unroll
    for (int k = 0; k < kSplitUnroll; ++k) {
      const int rr = r + k * step;
      if (rr < u.rows)
        v[k] = __ldg(reinterpret_cast<const uint4*>(x + base + static_cast<size_t>(rr) * C));
    }
#pragma unroll
    for (int k = 0; k < kSplitUnroll; ++k) {
      const int rr = r + k * step;
      if (rr < u.rows) {
        float f[kN];
        V::unpack(v[k], f);
#pragma unroll
        for (int j = 0; j < kN; ++j) f[j] = activate((f[j] - mu[j]) * rs[j], act, slope);
        *reinterpret_cast<uint4*>(y + base + static_cast<size_t>(rr) * C) = V::pack(f);
      }
    }
  }
}

// ----------------------------------------------------------------- backward

// g' = g * act'(y), with the kinks of ops/instance_norm.py:_act_grad: relu's
// derivative is 1 where y > 0, leaky_relu's 1 where y >= 0, else slope.
__device__ __forceinline__ float act_grad(float g, float y, int act, float slope) {
  if (act == kRelu) return g * (y > 0.f ? 1.f : 0.f);
  if (act == kLeakyRelu) return g * (y >= 0.f ? 1.f : slope);
  return g;
}

// Adds the two sums of one 16-byte vector of x and of g to sa and sb:
// sa += g', sb += g' * y, with y = (x - mu) * rs recomputed in fp32.
template <typename V>
__device__ __forceinline__ void bwd_accumulate(const uint4& xv, const uint4& gv, const float* mu,
                                               const float* rs, int act, float slope, float* sa,
                                               float* sb) {
  float f[V::kN], h[V::kN];
  V::unpack(xv, f);
  V::unpack(gv, h);
#pragma unroll
  for (int j = 0; j < V::kN; ++j) {
    const float y = (f[j] - mu[j]) * rs[j];
    const float gp = act_grad(h[j], y, act, slope);
    sa[j] += gp;
    sb[j] += gp * y;
  }
}

// dx of one 16-byte vector: rs * (g' - a - y * b), a and b the means of g'
// and g' * y over the sample, packed into x's dtype.
template <typename V>
__device__ __forceinline__ uint4 bwd_dx(const uint4& xv, const uint4& gv, const float* mu,
                                        const float* rs, const float* a, const float* b, int act,
                                        float slope) {
  float f[V::kN], h[V::kN];
  V::unpack(xv, f);
  V::unpack(gv, h);
#pragma unroll
  for (int j = 0; j < V::kN; ++j) {
    const float y = (f[j] - mu[j]) * rs[j];
    f[j] = rs[j] * (act_grad(h[j], y, act, slope) - a[j] - y * b[j]);
  }
  return V::pack(f);
}

// One block of the one-pass backward: rows [rank_row(rank), rank_row(rank +
// 1)) x kG channels of one sample, as the forward's one-pass block, with x
// and g both kept in shared memory. Each block sums g' and g' * y over its
// rows, the cluster's blocks add the k partials in rank order through
// distributed shared memory, and each block writes dx of its rows from
// shared memory.
template <typename T, int kCols>
__global__ void __launch_bounds__(kOnepassThreads, 2)
norm_bwd_onepass_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ mean, const float* __restrict__ rstd,
                        T* __restrict__ dx, int S, int C, int act, float slope) {
  using V = Vec<T>;
  constexpr int kN = V::kN, kG = kCols * kN, kStep = kOnepassThreads / kCols;
  extern __shared__ uint4 slab[];                  // x's rows x kCols vectors, then g's
  __shared__ float red[kOnepassThreads / 32 * kG];
  __shared__ float s_part[2 * kG];                 // local sums of g', g' * y: read by the peers
  __shared__ float s_mean[2 * kG];                 // their means over the sample

  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int group = blockIdx.x / k, n = blockIdx.y, col = threadIdx.x % kCols;
  const int r0 = rank_row(rank, S, k), rows = rank_row(rank + 1, S, k) - r0;
  const size_t base = (static_cast<size_t>(n) * S + r0) * C + group * kG + col * kN;
  uint4* gslab = slab + static_cast<size_t>(rows) * kCols;

  for (int r = threadIdx.x / kCols; r < rows; r += kStep) {
    cp_async_16(slab + r * kCols + col, x + base + static_cast<size_t>(r) * C);
    cp_async_16(gslab + r * kCols + col, g + base + static_cast<size_t>(r) * C);
  }
  const int c0 = n * C + group * kG + col * kN;
  float mu[kN], rs[kN], sa[kN], sb[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    mu[j] = __ldg(mean + c0 + j);
    rs[j] = __ldg(rstd + c0 + j);
    sa[j] = sb[j] = 0.f;
  }
  cp_async_wait_all();

#pragma unroll 2
  for (int r = threadIdx.x / kCols; r < rows; r += kStep)
    bwd_accumulate<V>(slab[r * kCols + col], gslab[r * kCols + col], mu, rs, act, slope, sa, sb);
  block_sum<kN, kOnepassThreads, kCols>(sa, red, s_part, 1.f);
  block_sum<kN, kOnepassThreads, kCols>(sb, red, s_part + kG, 1.f);

  // Every rank's sums are published: add them in rank order through
  // distributed shared memory, all k remote loads issued before the first
  // is used. Threads [0, kG) take the sums of g', [kG, 2 kG) those of g' y.
  cluster.sync();
  if (threadIdx.x < 2 * kG) {
    float part[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < k) part[r] = cluster.map_shared_rank(&s_part[0], r)[threadIdx.x];
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < k) total += part[r];
    s_mean[threadIdx.x] = total / static_cast<float>(S);
  }
  cluster_arrive();                                // done reading the peers
  __syncthreads();

  float a[kN], b[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) { a[j] = s_mean[col * kN + j]; b[j] = s_mean[kG + col * kN + j]; }
#pragma unroll 2
  for (int r = threadIdx.x / kCols; r < rows; r += kStep)
    *reinterpret_cast<uint4*>(dx + base + static_cast<size_t>(r) * C) =
        bwd_dx<V>(slab[r * kCols + col], gslab[r * kCols + col], mu, rs, a, b, act, slope);
  cluster_wait();                                  // no peer still reads s_part
}

// Adds, in order, partials [lo, hi) into (a, b): partial i has its sum of g'
// at p[i * stride] and of g' * y at p[i * stride + C]. Loads of kFoldBatch
// partials are issued before any is added, as chan_fold's.
__device__ void sum_fold(const float* p, size_t stride, int C, int lo, int hi, float& a,
                         float& b) {
  for (int i0 = lo; i0 < hi; i0 += kFoldBatch) {
    float ab[kFoldBatch], bb[kFoldBatch];
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) {
      if (i0 + k < hi) {
        ab[k] = __ldcg(p + static_cast<size_t>(i0 + k) * stride);
        bb[k] = __ldcg(p + static_cast<size_t>(i0 + k) * stride + C);
      }
    }
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) {
      if (i0 + k < hi) { a += ab[k]; b += bb[k]; }
    }
  }
}

// The split backward's first kernel, one block per tile as the forward's
// stats kernel: the tiles of x and of g come in by bulk copies onto one
// mbarrier, the block sums g' and g' * y over its rows, writes them to
// partial (N, n_tiles, 2, C), and the fold adds them in two levels of fixed
// order (groups of kFoldGroup tiles, then the groups) on the arrival
// counters, as the stats kernel's. The last block of each sample writes the
// sample's sums to sum_g and sum_gy (N, C): not yet divided by the count,
// so that a sharded slab's sums can be added over the shards first.
template <typename T>
__global__ void __launch_bounds__(kSplitMaxThreads)
norm_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ mean, const float* __restrict__ rstd,
                     float* __restrict__ partial, int* __restrict__ arrivals,
                     float* __restrict__ sum_g, float* __restrict__ sum_gy, int S, int C,
                     int vecs, int R, int act, float slope) {
  using V = Vec<T>;
  constexpr int kN = V::kN;
  extern __shared__ uint4 tile[];                  // x's R x vecs vectors, g's, then red
  __shared__ uint64_t bar;
  __shared__ float s_a[kSplitMaxVecs * kN], s_b[kSplitMaxVecs * kN];
  __shared__ int s_last;

  // The dx kernel, launched as this one's programmatic dependent, may be
  // scheduled (it waits for this grid's end before it reads the sums).
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int width = vecs * kN, nseg = C / width, n_tiles = (S + R - 1) / R;
  const SplitTile u = split_tile(blockIdx.x, S, R, n_tiles, nseg);
  const size_t off = (static_cast<size_t>(u.n) * S + u.r0) * C + u.seg * width;
  uint4* gtile = tile + static_cast<size_t>(R) * vecs;
  float* red = reinterpret_cast<float*>(gtile + static_cast<size_t>(R) * vecs);

  // Warp 0 brings both tiles in: one bulk copy of each contiguous span, or
  // one per row and tensor where the row is cut into segments.
  if (threadIdx.x == 0) mbarrier_init(&bar);
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned seg_bytes = static_cast<unsigned>(vecs * kVecBytes);
    if (threadIdx.x == 0) mbarrier_arrive_expect_tx(&bar, 2 * u.rows * seg_bytes);
    __syncwarp();
    if (nseg == 1) {
      if (threadIdx.x == 0) {
        bulk_load(tile, x + off, u.rows * seg_bytes, &bar);
        bulk_load(gtile, g + off, u.rows * seg_bytes, &bar);
      }
    } else {
      for (int r = threadIdx.x; r < u.rows; r += 32) {
        bulk_load(tile + r * vecs, x + off + static_cast<size_t>(r) * C, seg_bytes, &bar);
        bulk_load(gtile + r * vecs, g + off + static_cast<size_t>(r) * C, seg_bytes, &bar);
      }
    }
  }
  const int col = threadIdx.x % vecs, step = blockDim.x / vecs;
  const int c0 = u.n * C + u.seg * width + col * kN;
  float mu[kN], rs[kN], sa[kN], sb[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    mu[j] = __ldg(mean + c0 + j);
    rs[j] = __ldg(rstd + c0 + j);
    sa[j] = sb[j] = 0.f;
  }
  mbarrier_wait(&bar, 0);

#pragma unroll 2
  for (int r = threadIdx.x / vecs; r < u.rows; r += step)
    bwd_accumulate<V>(tile[r * vecs + col], gtile[r * vecs + col], mu, rs, act, slope, sa, sb);
  column_sum<kN>(sa, vecs, red, s_a, 1.f);
  column_sum<kN>(sb, vecs, red, s_b, 1.f);

  // Publish the tile's sums, then count this tile in its group.
  const size_t stride = 2 * static_cast<size_t>(C);
  float* p = partial + static_cast<size_t>(u.n) * n_tiles * stride + u.seg * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    p[u.t * stride + i] = s_a[i];
    p[u.t * stride + C + i] = s_b[i];
  }
  const int n_groups = (n_tiles + kFoldGroup - 1) / kFoldGroup, grp = u.t / kFoldGroup;
  const int g0 = grp * kFoldGroup, g1 = min(g0 + kFoldGroup, n_tiles);
  int* arrival = arrivals + (u.n * nseg + u.seg) * (n_groups + 1);
  if (threadIdx.x < width) __threadfence();        // the writers' stores, before the count
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrival + grp, 1) == g1 - g0 - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The group's last tile: add its tiles in order, over the first tile's.
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    float a = 0.f, b = 0.f;
    sum_fold(p + i, stride, C, g0, g1, a, b);
    p[g0 * stride + i] = a;
    p[g0 * stride + C + i] = b;
  }
  if (threadIdx.x == 0) arrival[grp] = 0;
  if (threadIdx.x < width) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrival + n_groups, 1) == n_groups - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The sample's last group: add the groups in order.
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    float a = 0.f, b = 0.f;
    sum_fold(p + i, kFoldGroup * stride, C, 0, n_groups, a, b);
    const int c = u.n * C + u.seg * width + i;
    sum_g[c] = a;
    sum_gy[c] = b;
  }
  if (threadIdx.x == 0) arrival[n_groups] = 0;
}

// The split backward's second kernel: one block per tile, as the sums
// kernel's, walked in reverse block order when `reverse` is set, so that it
// starts on the bytes the sums kernel read last. The means are the sums
// over `count` rows (the sample's, or the whole sharded sample's).
template <typename T>
__global__ void __launch_bounds__(kSplitMaxThreads)
norm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   const float* __restrict__ sum_g, const float* __restrict__ sum_gy,
                   T* __restrict__ dx, int S, int C, int vecs, int R, int reverse, float count,
                   int act, float slope) {
  using V = Vec<T>;
  constexpr int kN = V::kN;
  const int width = vecs * kN, nseg = C / width, n_tiles = (S + R - 1) / R;
  const int blk = reverse ? static_cast<int>(gridDim.x - 1 - blockIdx.x)
                          : static_cast<int>(blockIdx.x);
  const SplitTile u = split_tile(blk, S, R, n_tiles, nseg);
  const int col = threadIdx.x % vecs, step = blockDim.x / vecs;
  const int c0 = u.n * C + u.seg * width + col * kN;
  // Launched as the sums kernel's programmatic dependent: wait until that
  // grid has ended and its sums are visible (no wait otherwise).
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float mu[kN], rs[kN], a[kN], b[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    mu[j] = __ldg(mean + c0 + j);
    rs[j] = __ldg(rstd + c0 + j);
    a[j] = __ldcg(sum_g + c0 + j) / count;
    b[j] = __ldcg(sum_gy + c0 + j) / count;
  }

  const size_t base = (static_cast<size_t>(u.n) * S + u.r0) * C + u.seg * width + col * kN;
  for (int r = threadIdx.x / vecs; r < u.rows; r += kSplitUnroll * step) {
    uint4 xv[kSplitUnroll], gv[kSplitUnroll];
#pragma unroll
    for (int k = 0; k < kSplitUnroll; ++k) {
      const int rr = r + k * step;
      if (rr < u.rows) {
        xv[k] = __ldg(reinterpret_cast<const uint4*>(x + base + static_cast<size_t>(rr) * C));
        gv[k] = __ldg(reinterpret_cast<const uint4*>(g + base + static_cast<size_t>(rr) * C));
      }
    }
#pragma unroll
    for (int k = 0; k < kSplitUnroll; ++k) {
      const int rr = r + k * step;
      if (rr < u.rows)
        *reinterpret_cast<uint4*>(dx + base + static_cast<size_t>(rr) * C) =
            bwd_dx<V>(xv[k], gv[k], mu, rs, a, b, act, slope);
    }
  }
}

// ---------------------------------------------------------------- launchers

template <typename T, int kCols>
int launch_onepass(const void* x, void* y, void* mean, void* rstd, int n, int s, int c,
                   int k, float eps, int act, float slope, cudaStream_t stream) {
  constexpr int kG = kCols * Vec<T>::kN;
  const auto kernel = inorm_onepass_kernel<T, kCols>;
  const size_t smem = static_cast<size_t>((s + k - 1) / k) * kCols * kVecBytes;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    // Above 48 KB dynamic shared memory is granted only on request; a launch
    // that asks for more than granted is refused and never runs.
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess && k > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = k;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k * (c / kG), n);
  cfg.blockDim = dim3(kOnepassThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<T*>(y),
                           static_cast<float*>(mean), static_cast<float*>(rstd), s, c, eps,
                           act, slope);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Row segments of g channels: 32, 64 or 128 bytes (2, 4 or 8 vectors).
template <typename T>
int launch_onepass_g(const void* x, void* y, void* mean, void* rstd, int n, int s, int c,
                     int g, int k, float eps, int act, float slope, cudaStream_t stream) {
  if (g <= 0 || c % g || k < 1 || k > kMaxCluster || k > s)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (g * static_cast<int>(sizeof(T)) / kVecBytes) {
    case 2: return launch_onepass<T, 2>(x, y, mean, rstd, n, s, c, k, eps, act, slope, stream);
    case 4: return launch_onepass<T, 4>(x, y, mean, rstd, n, s, c, k, eps, act, slope, stream);
    case 8: return launch_onepass<T, 8>(x, y, mean, rstd, n, s, c, k, eps, act, slope, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Vectors per row segment of a split geometry, or 0 where the kernels do
// not take it: segments of 16 to 512 bytes that tile the row, at most
// kSplitMaxThreads threads in whole warps, and a whole number of threads per
// vector column.
template <typename T>
int split_vecs(int s, int c, int seg_bytes, int rows, int threads) {
  if (s < 1 || rows < 1 || seg_bytes < kVecBytes || seg_bytes % kVecBytes ||
      (c * static_cast<int>(sizeof(T))) % seg_bytes)
    return 0;
  const int vecs = seg_bytes / kVecBytes;
  if (vecs > kSplitMaxVecs || threads < 32 || threads > kSplitMaxThreads || threads % 32 ||
      threads % vecs)
    return 0;
  return vecs;
}

template <typename T>
unsigned split_blocks(int n, int s, int c, int seg_bytes, int rows) {
  return static_cast<unsigned>(n) * (c * static_cast<int>(sizeof(T)) / seg_bytes) *
         static_cast<unsigned>((s + rows - 1) / rows);
}

template <typename T>
int launch_split_stats(const void* x, void* partial, void* arrivals, void* mean, void* rstd,
                       int n, int s, int c, int seg_bytes, int rows, int threads, int m2_out,
                       float eps, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  const int vecs = split_vecs<T>(s, c, seg_bytes, rows, threads);
  if (!vecs) return static_cast<int>(cudaErrorInvalidValue);
  rows = rows < s ? rows : s;
  // The tile, then the column sums' scratch; the static scratch (the tile's
  // statistics, the barrier) comes on top.
  const int sums = (32 % vecs == 0 ? threads / 32 * vecs : threads) * kN;
  const size_t smem = static_cast<size_t>(rows) * vecs * kVecBytes + sums * sizeof(float);
  if (smem + 2 * kSplitMaxVecs * kN * sizeof(float) + 16 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = inorm_split_stats_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<split_blocks<T>(n, s, c, seg_bytes, rows), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partial), static_cast<int*>(arrivals),
      static_cast<float*>(mean), static_cast<float*>(rstd), s, c, vecs, rows, eps, m2_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_split_norm(const void* x, const void* mean, const void* rstd, void* y, int n,
                      int s, int c, int seg_bytes, int rows, int threads, int reverse, int act,
                      float slope, cudaStream_t stream) {
  const int vecs = split_vecs<T>(s, c, seg_bytes, rows, threads);
  if (!vecs) return static_cast<int>(cudaErrorInvalidValue);
  rows = rows < s ? rows : s;
  // A programmatic dependent launch: the kernel may be scheduled while the
  // previous kernel on the stream (the stats kernel) finishes, and waits
  // for its end in griddepcontrol.wait.
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split_blocks<T>(n, s, c, seg_bytes, rows));
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, inorm_split_norm_kernel<T>, static_cast<const T*>(x),
      static_cast<const float*>(mean), static_cast<const float*>(rstd), static_cast<T*>(y), s,
      c, vecs, rows, reverse, act, slope);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kCols>
int launch_bwd_onepass(const void* x, const void* g, const void* mean, const void* rstd,
                       void* dx, int n, int s, int c, int k, int act, float slope,
                       cudaStream_t stream) {
  constexpr int kG = kCols * Vec<T>::kN;
  const auto kernel = norm_bwd_onepass_kernel<T, kCols>;
  // x's rows and g's rows of the largest rank; the static scratch (the
  // column sums and the two pairs of sums) comes on top.
  const size_t smem = 2 * static_cast<size_t>((s + k - 1) / k) * kCols * kVecBytes;
  if (smem + (kOnepassThreads / 32 + 4) * kG * sizeof(float) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess && k > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = k;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k * (c / kG), n);
  cfg.blockDim = dim3(kOnepassThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(g),
                           static_cast<const float*>(mean), static_cast<const float*>(rstd),
                           static_cast<T*>(dx), s, c, act, slope);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_onepass_g(const void* x, const void* g, const void* mean, const void* rstd,
                         void* dx, int n, int s, int c, int gch, int k, int act, float slope,
                         cudaStream_t stream) {
  if (gch <= 0 || c % gch || k < 1 || k > kMaxCluster || k > s)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (gch * static_cast<int>(sizeof(T)) / kVecBytes) {
    case 2: return launch_bwd_onepass<T, 2>(x, g, mean, rstd, dx, n, s, c, k, act, slope, stream);
    case 4: return launch_bwd_onepass<T, 4>(x, g, mean, rstd, dx, n, s, c, k, act, slope, stream);
    case 8: return launch_bwd_onepass<T, 8>(x, g, mean, rstd, dx, n, s, c, k, act, slope, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_bwd_sums(const void* x, const void* g, const void* mean, const void* rstd,
                    void* partial, void* arrivals, void* sum_g, void* sum_gy, int n, int s, int c,
                    int seg_bytes, int rows, int threads, int act, float slope,
                    cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  const int vecs = split_vecs<T>(s, c, seg_bytes, rows, threads);
  if (!vecs) return static_cast<int>(cudaErrorInvalidValue);
  rows = rows < s ? rows : s;
  // The tiles of x and g, then the column sums' scratch; the static scratch
  // (the tile's two sums, the barrier) comes on top.
  const int sums = (32 % vecs == 0 ? threads / 32 * vecs : threads) * kN;
  const size_t smem = 2 * static_cast<size_t>(rows) * vecs * kVecBytes + sums * sizeof(float);
  if (smem + 2 * kSplitMaxVecs * kN * sizeof(float) + 16 > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = norm_bwd_sums_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<split_blocks<T>(n, s, c, seg_bytes, rows), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<float*>(partial), static_cast<int*>(arrivals),
      static_cast<float*>(sum_g), static_cast<float*>(sum_gy), s, c, vecs, rows, act, slope);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_dx(const void* x, const void* g, const void* mean, const void* rstd,
                  const void* sum_g, const void* sum_gy, void* dx, int n, int s, int c,
                  int seg_bytes, int rows, int threads, int reverse, float count, int act,
                  float slope, cudaStream_t stream) {
  const int vecs = split_vecs<T>(s, c, seg_bytes, rows, threads);
  if (!vecs || !(count > 0.f)) return static_cast<int>(cudaErrorInvalidValue);
  rows = rows < s ? rows : s;
  // A programmatic dependent launch of the sums kernel, as the normalise
  // kernel's of the stats kernel.
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split_blocks<T>(n, s, c, seg_bytes, rows));
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, norm_bwd_dx_kernel<T>, static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const float*>(sum_g), static_cast<const float*>(sum_gy), static_cast<T*>(dx),
      s, c, vecs, rows, reverse, count, act, slope);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 relu, 2 leaky_relu.
// Each returns the cudaError_t of its launch (0 on success).
extern "C" {

// g: channels per block (a 32, 64 or 128-byte row segment); k: cluster size.
int inorm_onepass(const void* x, void* y, void* mean, void* rstd, int n, int s, int c,
                  int dtype, int g, int k, float eps, int act, float slope, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_onepass_g<__nv_bfloat16>(x, y, mean, rstd, n, s, c, g, k, eps, act, slope, st)
      : launch_onepass_g<float>(x, y, mean, rstd, n, s, c, g, k, eps, act, slope, st);
}

// The split form's two kernels, at tiles of tile_rows rows x seg_bytes of
// each row, threads per block. partial: (n, tiles, 2, c) fp32 scratch, tiles
// = ceil(s / tile_rows); arrivals: n * (c * itemsize / seg_bytes) *
// (tiles + 1) ints or more, zero. m2_out: write the slab's M2 to rstd.
int inorm_split_stats(const void* x, void* partial, void* arrivals, void* mean, void* rstd,
                      int n, int s, int c, int dtype, int seg_bytes, int tile_rows,
                      int threads, int m2_out, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_split_stats<__nv_bfloat16>(x, partial, arrivals, mean, rstd, n, s, c, seg_bytes,
                                          tile_rows, threads, m2_out, eps, st)
      : launch_split_stats<float>(x, partial, arrivals, mean, rstd, n, s, c, seg_bytes,
                                  tile_rows, threads, m2_out, eps, st);
}

int inorm_split_norm(const void* x, const void* mean, const void* rstd, void* y, int n,
                     int s, int c, int dtype, int seg_bytes, int tile_rows, int threads,
                     int reverse, int act, float slope, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_split_norm<__nv_bfloat16>(x, mean, rstd, y, n, s, c, seg_bytes, tile_rows,
                                         threads, reverse, act, slope, st)
      : launch_split_norm<float>(x, mean, rstd, y, n, s, c, seg_bytes, tile_rows, threads,
                                 reverse, act, slope, st);
}

// The backward: dx of x (n, s, c) from the output's gradient g (same shape
// and dtype) and the forward's fp32 mean and rstd (n, c).
// gch: channels per block (a 32, 64 or 128-byte row segment); k: cluster size.
int norm_bwd_onepass(const void* x, const void* g, const void* mean, const void* rstd, void* dx,
                     int n, int s, int c, int dtype, int gch, int k, int act, float slope,
                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_bwd_onepass_g<__nv_bfloat16>(x, g, mean, rstd, dx, n, s, c, gch, k, act, slope, st)
      : launch_bwd_onepass_g<float>(x, g, mean, rstd, dx, n, s, c, gch, k, act, slope, st);
}

// The split backward's sums, at the split geometry: partial (n, tiles, 2, c)
// fp32 scratch and arrivals as inorm_split_stats's; writes the sums of g'
// and of g' * y to sum_g and sum_gy (n, c) fp32.
int norm_bwd_sums(const void* x, const void* g, const void* mean, const void* rstd,
                  void* partial, void* arrivals, void* sum_g, void* sum_gy, int n, int s, int c,
                  int dtype, int seg_bytes, int tile_rows, int threads, int act, float slope,
                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_bwd_sums<__nv_bfloat16>(x, g, mean, rstd, partial, arrivals, sum_g, sum_gy, n,
                                       s, c, seg_bytes, tile_rows, threads, act, slope, st)
      : launch_bwd_sums<float>(x, g, mean, rstd, partial, arrivals, sum_g, sum_gy, n, s, c,
                               seg_bytes, tile_rows, threads, act, slope, st);
}

// The split backward's dx from the sums over count rows.
int norm_bwd_dx(const void* x, const void* g, const void* mean, const void* rstd,
                const void* sum_g, const void* sum_gy, void* dx, int n, int s, int c, int dtype,
                int seg_bytes, int tile_rows, int threads, int reverse, float count, int act,
                float slope, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_bwd_dx<__nv_bfloat16>(x, g, mean, rstd, sum_g, sum_gy, dx, n, s, c, seg_bytes,
                                     tile_rows, threads, reverse, count, act, slope, st)
      : launch_bwd_dx<float>(x, g, mean, rstd, sum_g, sum_gy, dx, n, s, c, seg_bytes, tile_rows,
                             threads, reverse, count, act, slope, st);
}

}  // extern "C"
