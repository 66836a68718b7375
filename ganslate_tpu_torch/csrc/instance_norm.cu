// Fused instance norm (+ ReLU / LeakyReLU) forward for Hopper (sm_90a).
//
// x is the contiguous (N, S, C) view of a channels-last (N, *spatial, C)
// tensor, the layout the JAX package's Pallas kernels see. Statistics are
// fp32 (mean and biased variance per sample and channel), y = act((x - mean)
// * rstd) is cast back to x's dtype (float or bfloat16), and the fp32 mean
// and rstd = 1 / sqrt(var + eps) of shape (N, C) are returned beside it.
//
// Kernels and the TPU kernels they replace (ganslate_tpu/ops/instance_norm.py):
//   inorm_onepass_kernel      _pallas_forward (pallas_call at :85)
//   inorm_split_stats_kernel  _pallas_forward_tiled, stats_kernel (:122-135, pallas_call at :137)
//   inorm_split_fold_kernel   _pallas_forward_tiled, the stats fold in XLA (:148-151)
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
// Split design: blocks over (channel block, tile of kTile rows, sample).
// Hopper has no ordered grid, so the TPU kernel's accumulator revisited
// across tiles has no counterpart: each tile writes its own (mean, M2) and
// a fold kernel merges the tiles in order with Chan's formula, which keeps
// the variance exact where E[x^2] - E[x]^2 cancels (|mean| >> std). No
// atomics: the result is deterministic. It reads x twice and writes y once,
// 1.5x the bound's bytes, in exchange for N * C / CB * S / kTile blocks. Each
// block reads one 32-byte column out of every C * itemsize-byte row, and runs
// at about a third of the card's memory rate (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRowBytes = 32;                 // split form: one channel block row = one sector
constexpr int kVecBytes = 16;                 // one vector access
constexpr int kVpr = kRowBytes / kVecBytes;   // split form: vectors per row
constexpr int kOnepassThreads = 256;
constexpr int kMaxCluster = 16;               // above 8 needs the non-portable attribute
constexpr int kSplitThreads = 256;
constexpr int kTile = 1024;                   // rows per split tile
constexpr int kFoldThreads = 128;

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
template <int kN, int kThreads, int kCols = kVpr>
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

// Mean and M2 = sum((x - mean)^2) of rows [0, rows) of a slab held in shared
// memory (row r, column col at slab[r * kVpr + col]); partial per-thread sums
// in `sum` on entry (taken while the slab was loaded).
template <typename T, int kThreads>
__device__ void slab_moments(const uint4* slab, int rows, float (&sum)[Vec<T>::kN],
                             float* red, float* s_mean, float* s_m2) {
  using V = Vec<T>;
  constexpr int kN = V::kN;
  const int col = threadIdx.x % kVpr;
  block_sum<kN, kThreads>(sum, red, s_mean, static_cast<float>(rows));
  float mu[kN], m2[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) { mu[j] = s_mean[col * kN + j]; m2[j] = 0.f; }
  for (int r = threadIdx.x / kVpr; r < rows; r += kThreads / kVpr) {
    float f[kN];
    V::unpack(slab[r * kVpr + col], f);
#pragma unroll
    for (int j = 0; j < kN; ++j) { const float d = f[j] - mu[j]; m2[j] += d * d; }
  }
  block_sum<kN, kThreads>(m2, red, s_m2, 1.f);
}

// Copies rows [0, rows) of one channel block (row r at src + r * C) into
// slab (row r, column col at slab[r * kVpr + col]) and adds the values to
// sum.
template <typename T, int kThreads>
__device__ void load_slab(const T* __restrict__ src, int C, int rows, uint4* slab,
                          float (&sum)[Vec<T>::kN]) {
  using V = Vec<T>;
  constexpr int kStep = kThreads / kVpr;
  const int col = threadIdx.x % kVpr;
#pragma unroll 4
  for (int r = threadIdx.x / kVpr; r < rows; r += kStep) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * C));
    slab[r * kVpr + col] = v;
    float f[V::kN];
    V::unpack(v, f);
#pragma unroll
    for (int j = 0; j < V::kN; ++j) sum[j] += f[j];
  }
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
  // distributed shared memory (Chan et al., as inorm_split_fold_kernel).
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

// partial is (N, T, 2, C) fp32: the tile's mean, then its M2.
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
inorm_split_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                         int S, int C) {
  using V = Vec<T>;
  constexpr int kN = V::kN, kCb = kVpr * kN;
  __shared__ uint4 tile[kTile * kVpr];
  __shared__ float red[kSplitThreads / 32 * kCb];
  __shared__ float s_mean[kCb], s_m2[kCb];

  const int t = blockIdx.y, n = blockIdx.z, col = threadIdx.x % kVpr;
  const int row0 = t * kTile, rows = min(kTile, S - row0);
  const size_t base = (static_cast<size_t>(n) * S + row0) * C + blockIdx.x * kCb + col * kN;

  float sum[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) sum[j] = 0.f;
  load_slab<T, kSplitThreads>(x + base, C, rows, tile, sum);
  slab_moments<T, kSplitThreads>(tile, rows, sum, red, s_mean, s_m2);
  if (threadIdx.x < kCb) {
    const int n_tiles = gridDim.y;
    float* p = partial + (static_cast<size_t>(n) * n_tiles + t) * 2 * C + blockIdx.x * kCb + threadIdx.x;
    p[0] = s_mean[threadIdx.x];
    p[C] = s_m2[threadIdx.x];
  }
}

// One thread per (sample, channel): merges the tiles' (count, mean, M2) in
// tile order (Chan et al.), then writes mean and rstd.
__global__ void __launch_bounds__(kFoldThreads)
inorm_split_fold_kernel(const float* __restrict__ partial, float* __restrict__ mean_out,
                        float* __restrict__ rstd_out, int N, int S, int C, int n_tiles,
                        float eps) {
  const int i = blockIdx.x * kFoldThreads + threadIdx.x;
  if (i >= N * C) return;
  const int n = i / C, c = i % C;
  const float* p = partial + static_cast<size_t>(n) * n_tiles * 2 * C + c;
  float count = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll 4
  for (int t = 0; t < n_tiles; ++t) {
    const float nb = static_cast<float>(min(kTile, S - t * kTile));
    const float mb = p[static_cast<size_t>(t) * 2 * C];
    const float m2b = p[static_cast<size_t>(t) * 2 * C + C];
    const float total = count + nb;
    const float d = mb - mean;
    mean += d * (nb / total);
    m2 += m2b + d * d * (count * nb / total);
    count = total;
  }
  mean_out[i] = mean;
  rstd_out[i] = 1.f / sqrtf(m2 / S + eps);
}

template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
inorm_split_norm_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                        const float* __restrict__ rstd, T* __restrict__ y, int S, int C,
                        int act, float slope) {
  using V = Vec<T>;
  constexpr int kN = V::kN, kCb = kVpr * kN, kStep = kSplitThreads / kVpr;
  const int t = blockIdx.y, n = blockIdx.z, col = threadIdx.x % kVpr;
  const int row0 = t * kTile, rows = min(kTile, S - row0);
  const int c0 = n * C + blockIdx.x * kCb + col * kN;
  float mu[kN], rs[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) { mu[j] = __ldg(mean + c0 + j); rs[j] = __ldg(rstd + c0 + j); }

  const size_t base = (static_cast<size_t>(n) * S + row0) * C + blockIdx.x * kCb + col * kN;
#pragma unroll 4
  for (int r = threadIdx.x / kVpr; r < rows; r += kStep) {
    const size_t off = base + static_cast<size_t>(r) * C;
    float f[kN];
    V::unpack(__ldg(reinterpret_cast<const uint4*>(x + off)), f);
#pragma unroll
    for (int j = 0; j < kN; ++j) f[j] = activate((f[j] - mu[j]) * rs[j], act, slope);
    *reinterpret_cast<uint4*>(y + off) = V::pack(f);
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

template <typename T>
int launch_split_stats(const void* x, void* partial, int n, int s, int c, cudaStream_t stream) {
  constexpr int kCb = kVpr * Vec<T>::kN;
  const int n_tiles = (s + kTile - 1) / kTile;
  inorm_split_stats_kernel<T><<<dim3(c / kCb, n_tiles, n), kSplitThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partial), s, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_split_norm(const void* x, const void* mean, const void* rstd, void* y, int n,
                      int s, int c, int act, float slope, cudaStream_t stream) {
  constexpr int kCb = kVpr * Vec<T>::kN;
  const int n_tiles = (s + kTile - 1) / kTile;
  inorm_split_norm_kernel<T><<<dim3(c / kCb, n_tiles, n), kSplitThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<T*>(y), s, c, act, slope);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 relu, 2 leaky_relu.
// Each returns the cudaError_t of its launch (0 on success).
extern "C" {

int inorm_split_tile_rows() { return kTile; }

// g: channels per block (a 32, 64 or 128-byte row segment); k: cluster size.
int inorm_onepass(const void* x, void* y, void* mean, void* rstd, int n, int s, int c,
                  int dtype, int g, int k, float eps, int act, float slope, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_onepass_g<__nv_bfloat16>(x, y, mean, rstd, n, s, c, g, k, eps, act, slope, st)
      : launch_onepass_g<float>(x, y, mean, rstd, n, s, c, g, k, eps, act, slope, st);
}

int inorm_split_stats(const void* x, void* partial, int n, int s, int c, int dtype,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_split_stats<__nv_bfloat16>(x, partial, n, s, c, st)
                    : launch_split_stats<float>(x, partial, n, s, c, st);
}

int inorm_split_fold(const void* partial, void* mean, void* rstd, int n, int s, int c,
                     float eps, void* stream) {
  const int n_tiles = (s + kTile - 1) / kTile;
  const int blocks = (n * c + kFoldThreads - 1) / kFoldThreads;
  inorm_split_fold_kernel<<<blocks, kFoldThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(mean),
      static_cast<float*>(rstd), n, s, c, n_tiles, eps);
  return static_cast<int>(cudaGetLastError());
}

int inorm_split_norm(const void* x, const void* mean, const void* rstd, void* y, int n,
                     int s, int c, int dtype, int act, float slope, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_split_norm<__nv_bfloat16>(x, mean, rstd, y, n, s, c, act, slope, st)
      : launch_split_norm<float>(x, mean, rstd, y, n, s, c, act, slope, st);
}

}  // extern "C"
