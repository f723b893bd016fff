// Native harness core for tpuaudiobench.
//
// C++ ports of the reference's native harness components (the parts of
// cuda/bench_utils.cu, cuda/globals.cu and the Metal DAWSimulator that
// are performance-sensitive host code), exposed with a C ABI for
// ctypes:
//
//  * gpuab_calculate_statistics: mean/median/sample-stddev/min/max and
//    linearly interpolated p95/p99 (port of
//    BenchmarkUtils::calculateStatistics, bench_utils.cu:358-414).
//  * gpuab_csv_percentile: the CSV writers' truncated-index percentile
//    (globals.cu:86-88).
//  * gpuab_dawsim_*: DAW-load pacing -- spin or sleep until the next
//    audio-buffer boundary with optional uniform jitter (port of
//    DAWSimulator, BenchmarkUtilities.swift:140-178). The spin path is
//    a tight clock_gettime loop, free of Python-interpreter jitter.
//  * gpuab_monotonic_ns: monotonic clock for wall timing
//    (BenchmarkTimer analog, bench_utils.cu:187-220).
//
// Build: native/Makefile -> build/libgpuab_native.so; loaded by
// gpuaudiobench_tpu/utils/native.py (pure-Python fallbacks exist).

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

extern "C" {

struct GpuabStats {
  double mean;
  double median;
  double std_dev;
  double min_val;
  double max_val;
  double p95;
  double p99;
  int64_t count;
};

static double interp_percentile(const std::vector<double>& sorted, double p) {
  if (sorted.empty()) return 0.0;
  const double index = p / 100.0 * static_cast<double>(sorted.size() - 1);
  const size_t lower = static_cast<size_t>(std::floor(index));
  const size_t upper = static_cast<size_t>(std::ceil(index));
  if (lower == upper) return sorted[lower];
  const double weight = index - static_cast<double>(lower);
  return sorted[lower] * (1.0 - weight) + sorted[upper] * weight;
}

int gpuab_calculate_statistics(const double* latencies, int64_t n,
                               GpuabStats* out) {
  if (out == nullptr) return -1;
  std::memset(out, 0, sizeof(GpuabStats));
  if (latencies == nullptr || n <= 0) return 0;

  std::vector<double> sorted(latencies, latencies + n);
  std::sort(sorted.begin(), sorted.end());

  out->count = n;
  out->min_val = sorted.front();
  out->max_val = sorted.back();
  out->mean = std::accumulate(latencies, latencies + n, 0.0) /
              static_cast<double>(n);

  const size_t mid = static_cast<size_t>(n) / 2;
  out->median = (n % 2 == 0) ? (sorted[mid - 1] + sorted[mid]) / 2.0
                             : sorted[mid];

  if (n > 1) {
    double variance = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      const double d = latencies[i] - out->mean;
      variance += d * d;
    }
    variance /= static_cast<double>(n - 1);
    out->std_dev = std::sqrt(variance);
  }

  out->p95 = interp_percentile(sorted, 95.0);
  out->p99 = interp_percentile(sorted, 99.0);
  return 0;
}

double gpuab_csv_percentile(const double* sorted_vals, int64_t n, double p) {
  if (sorted_vals == nullptr || n <= 0) return 0.0;
  int64_t idx = static_cast<int64_t>(static_cast<double>(n) * p);
  if (idx > n - 1) idx = n - 1;
  return sorted_vals[idx];
}

int64_t gpuab_monotonic_ns(void) {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ---- DAW-load simulator ---------------------------------------------------

struct GpuabDawSim {
  double buffer_duration_ns;
  double next_start_ns;  // <0: uninitialized
  int mode;              // 0 = spin, 1 = sleep
  double jitter_ns;
  std::mt19937 rng;
};

GpuabDawSim* gpuab_dawsim_create(int buffer_size, int fs, int mode,
                                 double jitter_us, uint32_t seed) {
  auto* s = new GpuabDawSim();
  s->buffer_duration_ns =
      1e9 * static_cast<double>(buffer_size) / static_cast<double>(fs);
  s->next_start_ns = -1.0;
  s->mode = mode;
  s->jitter_ns = jitter_us * 1e3;
  s->rng.seed(seed);
  return s;
}

void gpuab_dawsim_destroy(GpuabDawSim* s) { delete s; }

void gpuab_dawsim_reset(GpuabDawSim* s) {
  if (s) s->next_start_ns = -1.0;
}

// Blocks until the next buffer boundary (BenchmarkUtilities.swift:154-177).
void gpuab_dawsim_wait(GpuabDawSim* s) {
  if (s == nullptr) return;
  const double now = static_cast<double>(gpuab_monotonic_ns());
  if (s->next_start_ns < 0.0) {
    s->next_start_ns = now + s->buffer_duration_ns;
    return;
  }
  double target = s->next_start_ns;
  if (s->jitter_ns > 0.0) {
    std::uniform_real_distribution<double> dist(-s->jitter_ns, s->jitter_ns);
    target += dist(s->rng);
  }
  if (s->mode == 1) {  // sleep
    const double remaining = target - now;
    if (remaining > 0) {
      std::this_thread::sleep_for(
          std::chrono::nanoseconds(static_cast<int64_t>(remaining)));
    }
  } else {  // spin
    while (static_cast<double>(gpuab_monotonic_ns()) < target) {
    }
  }
  s->next_start_ns += s->buffer_duration_ns;
  const double after = static_cast<double>(gpuab_monotonic_ns());
  if (s->next_start_ns < after) {
    s->next_start_ns = after + s->buffer_duration_ns;
  }
}

}  // extern "C"
