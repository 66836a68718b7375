// Host data ops of the port's loader pipeline: the port's own copy of the
// JAX package's `ganslate_tpu/native/dataops.cpp`, with the same C ABI and
// the same arithmetic, so that both packages give the same bits when both
// are built with the same flags on the same host.
//
// The 3D medical data path streams 100MB+ float volumes per sample through
// clip+normalize, z-scores and masked fills before they reach the device
// (projects/maastro_hx4_pet_translation masks 3-4 whole volumes a sample
// and normalises padded 64x512x512 validation volumes; a BRaTS validation
// scan z-scores two 155x240x240 sequences). Single-threaded numpy makes
// these a loader bottleneck; these loops are multithreaded and write in
// one pass. They are bound by the host's memory bandwidth. Do not rewrite
// an expression: its bits are what the tests hold against the JAX
// package's build.
//
// Exposed via a plain C ABI consumed with ctypes
// (ganslate_tpu_torch/native/__init__.py); built at first use by
// ganslate_tpu_torch/ops/build.py:build_host.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int default_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(std::min(n, 16u));
}

// Run fn(begin, end) over [0, total) split across threads.
template <typename F>
void parallel_for(int64_t total, F fn, int threads) {
  if (threads <= 1 || total < (1 << 16)) {
    fn(0, total);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (total + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = std::min(total, begin + chunk);
    if (begin >= end) break;
    pool.emplace_back([=] { fn(begin, end); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// out[i] = 2 * (clip(in[i], lo, hi) - lo) / (hi - lo) - 1
// (the clip_and_min_max_normalize hot loop; in-place allowed: out may == in)
void clip_minmax_normalize_f32(const float* in, float* out, int64_t n,
                               float lo, float hi) {
  const float scale = 2.0f / (hi - lo);
  parallel_for(
      n,
      [=](int64_t begin, int64_t end) {
        for (int64_t i = begin; i < end; ++i) {
          float v = in[i];
          v = v < lo ? lo : (v > hi ? hi : v);
          out[i] = (v - lo) * scale - 1.0f;
        }
      },
      default_threads());
}

// Single-pass mean / stddev (population) of a float array.
void mean_std_f32(const float* in, int64_t n, double* mean_out,
                  double* std_out) {
  int threads = default_threads();
  std::vector<double> sums(threads, 0.0), sqs(threads, 0.0);
  std::atomic<int> slot{0};
  int64_t chunk = (n + threads - 1) / threads;
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = std::min(n, begin + chunk);
    if (begin >= end) break;
    pool.emplace_back([&, begin, end, t] {
      double s = 0.0, q = 0.0;
      for (int64_t i = begin; i < end; ++i) {
        double v = in[i];
        s += v;
        q += v * v;
      }
      sums[t] = s;
      sqs[t] = q;
    });
  }
  for (auto& th : pool) th.join();
  double s = 0.0, q = 0.0;
  for (int t = 0; t < threads; ++t) {
    s += sums[t];
    q += sqs[t];
  }
  double mean = s / static_cast<double>(n);
  double var = q / static_cast<double>(n) - mean * mean;
  *mean_out = mean;
  *std_out = std::sqrt(var > 0 ? var : 0.0);
}

// out = (in - mean) / std, optional rescale of [smin, smax] -> [rmin, rmax].
void zscore_normalize_f32(const float* in, float* out, int64_t n, float mean,
                          float stddev, int rescale, float smin, float smax,
                          float rmin, float rmax) {
  const float inv = 1.0f / stddev;
  const float d1 = smax - smin;
  const float d2 = rmax - rmin;
  parallel_for(
      n,
      [=](int64_t begin, int64_t end) {
        for (int64_t i = begin; i < end; ++i) {
          float v = (in[i] - mean) * inv;
          if (rescale) v = d2 * (v - smin) / d1 + rmin;
          out[i] = v;
        }
      },
      default_threads());
}

// Copy a (dz, dy, dx) patch starting at (z, y, x) from a (Z, Y, X) volume.
void extract_patch_f32(const float* vol, float* out, int64_t Z, int64_t Y,
                       int64_t X, int64_t z, int64_t y, int64_t x, int64_t dz,
                       int64_t dy, int64_t dx) {
  parallel_for(
      dz,
      [=](int64_t begin, int64_t end) {
        for (int64_t iz = begin; iz < end; ++iz) {
          const float* src_plane = vol + (z + iz) * Y * X;
          float* dst_plane = out + iz * dy * dx;
          for (int64_t iy = 0; iy < dy; ++iy) {
            std::memcpy(dst_plane + iy * dx, src_plane + (y + iy) * X + x,
                        sizeof(float) * static_cast<size_t>(dx));
          }
        }
      },
      default_threads());
}

// masked fill: out[i] = mask[i] ? in[i] : fill  (body-mask application)
void masked_fill_f32(const float* in, const uint8_t* mask, float* out,
                     int64_t n, float fill) {
  parallel_for(
      n,
      [=](int64_t begin, int64_t end) {
        for (int64_t i = begin; i < end; ++i) {
          out[i] = mask[i] ? in[i] : fill;
        }
      },
      default_threads());
}

}  // extern "C"
