// Fused instance norm (+ ReLU / LeakyReLU) forward for Hopper (sm_90a).
//
// x is the contiguous (N, S, C) view of a channels-last (N, *spatial, C)
// tensor, the layout the JAX package's Pallas kernels see. Statistics are
// fp32 (mean and biased variance per sample and channel), y = act((x - mean)
// * rstd) is cast back to x's dtype (float or bfloat16), and the fp32 mean
// and rstd = 1 / sqrt(var + eps) of shape (N, C) are returned beside it.
//
// Every block owns one channel block of CB channels. One row of a channel
// block is one 32-byte sector (CB = 16 bf16 or 8 float), read and written as
// two 16-byte vectors by two neighbouring threads, so every device-memory
// access moves whole sectors. C must be a multiple of CB.
//
// Kernels and the TPU kernels they replace (ganslate_tpu/ops/instance_norm.py):
//   inorm_onepass_kernel      _pallas_forward (pallas_call at :85)
//   inorm_split_stats_kernel  _pallas_forward_tiled, stats_kernel (:122-135, pallas_call at :137)
//   inorm_split_fold_kernel   _pallas_forward_tiled, the stats fold in XLA (:148-151)
//   inorm_split_norm_kernel   _pallas_forward_tiled, norm_kernel (:153-156, pallas_call at :160)
//
// Bound on an H100 SXM (3.35 TB/s HBM3): the op must read x once and write y
// once, 2 * N*S*C*itemsize bytes; e.g. bf16 (16, 64*64, 256) moves 67 MB,
// 20 us. The arithmetic (about 8 fp32 operations per element) is far below
// the card's rate, so the bytes bound it.
//
// One-pass design: the (S, CB) slab of one sample lives in shared memory, so
// x is read from device memory once and y written once, the bound's own
// traffic. The slab must fit one block's shared memory (at most 227 KB, i.e.
// S <= ~7000 rows); the Python dispatch sends larger slabs to the split form.
// Its weakness is parallelism: N * C / CB blocks of one per SM (the slab
// takes most of the SM's shared memory), e.g. 256 blocks at batch 16 but 16
// at batch 1 for the 64x64x256 residual slabs.
//
// Split design: blocks over (channel block, tile of kTile rows, sample).
// Hopper has no ordered grid, so the TPU kernel's accumulator revisited
// across tiles has no counterpart: each tile writes its own (mean, M2) and
// a fold kernel merges the tiles in order with Chan's formula, which keeps
// the variance exact where E[x^2] - E[x]^2 cancels (|mean| >> std). No
// atomics: the result is deterministic. It reads x twice and writes y once,
// 1.5x the bound's bytes, in exchange for N * C / CB * S / kTile blocks.
//
// Both forms run at about a third of the card's memory rate (PERF.md): a
// block reads one 32-byte column out of every C * itemsize-byte row, and
// keeping more loads in flight per thread did not help. Reading whole rows
// per block (a cluster of blocks sharing the one-pass slab through
// distributed shared memory) is the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRowBytes = 32;                 // one channel block row = one sector
constexpr int kVecBytes = 16;                 // one vector access
constexpr int kVpr = kRowBytes / kVecBytes;   // vectors per row
constexpr int kOnepassThreads = 512;
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
// kVpr) and writes total / divisor for each of the block's kVpr * kN
// channels to out. red holds kThreads / 32 * kVpr * kN floats. Ends with a
// barrier, so out is visible to every thread on return.
template <int kN, int kThreads>
__device__ void block_sum(float (&v)[kN], float* red, float* out, float divisor) {
#pragma unroll
  for (int off = 16; off >= kVpr; off >>= 1)
#pragma unroll
    for (int j = 0; j < kN; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < kVpr)
#pragma unroll
    for (int j = 0; j < kN; ++j) red[(warp * kVpr + lane) * kN + j] = v[j];
  __syncthreads();
  if (threadIdx.x < kVpr * kN) {
    const int col = threadIdx.x / kN, e = threadIdx.x % kN;
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[(w * kVpr + col) * kN + e];
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

template <typename T>
__global__ void __launch_bounds__(kOnepassThreads)
inorm_onepass_kernel(const T* __restrict__ x, T* __restrict__ y,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out,
                     int S, int C, float eps, int act, float slope) {
  using V = Vec<T>;
  constexpr int kN = V::kN, kCb = kVpr * kN, kStep = kOnepassThreads / kVpr;
  extern __shared__ uint4 slab[];                    // S rows x kVpr vectors
  __shared__ float red[kOnepassThreads / 32 * kCb];
  __shared__ float s_mean[kCb], s_rstd[kCb];

  const int n = blockIdx.y, col = threadIdx.x % kVpr;
  const size_t base = static_cast<size_t>(n) * S * C + blockIdx.x * kCb + col * kN;

  float sum[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) sum[j] = 0.f;
  load_slab<T, kOnepassThreads>(x + base, C, S, slab, sum);
  slab_moments<T, kOnepassThreads>(slab, S, sum, red, s_mean, s_rstd);
  if (threadIdx.x < kCb) {
    const float rstd = 1.f / sqrtf(s_rstd[threadIdx.x] / S + eps);
    s_rstd[threadIdx.x] = rstd;
    const int c = blockIdx.x * kCb + threadIdx.x;
    mean_out[n * C + c] = s_mean[threadIdx.x];
    rstd_out[n * C + c] = rstd;
  }
  __syncthreads();

  float mu[kN], rs[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) { mu[j] = s_mean[col * kN + j]; rs[j] = s_rstd[col * kN + j]; }
#pragma unroll 4
  for (int r = threadIdx.x / kVpr; r < S; r += kStep) {
    float f[kN];
    V::unpack(slab[r * kVpr + col], f);
#pragma unroll
    for (int j = 0; j < kN; ++j) f[j] = activate((f[j] - mu[j]) * rs[j], act, slope);
    *reinterpret_cast<uint4*>(y + base + static_cast<size_t>(r) * C) = V::pack(f);
  }
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

template <typename T>
int launch_onepass(const void* x, void* y, void* mean, void* rstd, int n, int s, int c,
                   float eps, int act, float slope, cudaStream_t stream) {
  constexpr int kCb = kVpr * Vec<T>::kN;
  const size_t smem = static_cast<size_t>(s) * kRowBytes;
  if (smem > 48 * 1024) {
    // Above 48 KB dynamic shared memory is granted only on request; a launch
    // that asks for more than granted is refused and never runs.
    const cudaError_t err = cudaFuncSetAttribute(
        inorm_onepass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  inorm_onepass_kernel<T><<<dim3(c / kCb, n), kOnepassThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), s, c, eps, act, slope);
  return static_cast<int>(cudaGetLastError());
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

int inorm_onepass(const void* x, void* y, void* mean, void* rstd, int n, int s, int c,
                  int dtype, float eps, int act, float slope, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_onepass<__nv_bfloat16>(x, y, mean, rstd, n, s, c, eps, act, slope, st)
      : launch_onepass<float>(x, y, mean, rstd, n, s, c, eps, act, slope, st);
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
