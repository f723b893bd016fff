// native_runner: runs an AOTInductor package with no interpreter in the
// process.
//
// The port's counterpart of native/pjrt_runner.cc, at the same layer: the
// reference's harness is a native binary driving the GPU runtime
// (cuda/main.cu). It loads a program that tools/export_programs.py wrote
// (torch.export, compiled and packaged by AOTInductor) with libtorch's
// package loader, uploads seeded inputs, makes one warm-up round trip and N
// timed ones, and prints the latencies: the benchmark's hot path with no
// Python in the process. The hand-written kernels are operators of the
// `gpuab` library (csrc/torch_ops.cc), which the package calls by name
// through the dispatcher, so that library is loaded (RTLD_GLOBAL) before
// the package.
//
// Usage:
//   native_runner --package P.pt2 --spec P.spec [--ops LIB.so]
//                 [--runs N] [--device cuda|cpu]
//
// The .spec file has one line an input, `f32 128 512` (or i32). The inputs
// are seeded as pjrt_runner seeds them, bit for bit: one LCG (NextRand)
// from 42 through every input in order, an S32 input by its rule. A round
// trip is one run of the package, a synchronisation of its stream and the
// copy of output 0 to the host; the warm-up prints the sum of that
// output's first 64 elements.
//
// Built by utils/native.py:build_runner with g++ against libtorch
// (torch, torch_cpu, c10; with GPUAB_WITH_CUDA also torch_cuda and
// c10_cuda) and libdl, never libpython.

#include <dlfcn.h>

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <exception>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#ifdef GPUAB_WITH_CUDA
#include <c10/cuda/CUDAFunctions.h>
#include <c10/cuda/CUDAStream.h>
#endif

namespace {

[[noreturn]] void Die(const std::string& what) {
  std::fprintf(stderr, "native_runner: %s\n", what.c_str());
  std::exit(1);
}

struct InputSpec {
  bool is_i32 = false;
  std::vector<int64_t> dims;
  int64_t elems() const {
    int64_t n = 1;
    for (int64_t d : dims) n *= d;
    return n;
  }
};

std::vector<InputSpec> ParseSpec(const std::string& path) {
  std::ifstream f(path);
  if (!f) Die("cannot read " + path);
  std::vector<InputSpec> specs;
  std::string line;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ss(line);
    std::string ty;
    ss >> ty;
    InputSpec spec;
    if (ty == "i32") {
      spec.is_i32 = true;
    } else if (ty != "f32") {
      Die("unsupported dtype " + ty);
    }
    int64_t d;
    while (ss >> d) spec.dims.push_back(d);
    specs.push_back(spec);
  }
  return specs;
}

// pjrt_runner.cc's NextRand: the same LCG, the same f32 rule.
float NextRand(uint64_t* state) {
  *state = *state * 6364136223846793005ULL + 1442695040888963407ULL;
  return 2.0f * ((*state >> 33) & 0xFFFFFF) / 16777216.0f - 1.0f;
}

double Percentile(std::vector<double> v, double p) {
  if (v.empty()) return 0.0;
  std::sort(v.begin(), v.end());
  return v[static_cast<size_t>(p * (v.size() - 1))];
}

double Ms(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double, std::milli>(
             std::chrono::steady_clock::now() - t0)
      .count();
}

void Usage() {
  std::fprintf(stderr,
               "usage: native_runner --package P.pt2 --spec P.spec "
               "[--ops LIB.so] [--runs N] [--device cuda|cpu]\n");
}

int Run(int argc, char** argv) {
  std::string package_path, spec_path, ops_path, device_name = "cuda";
  int runs = 20;
  if (argc < 2) {
    Usage();
    return 1;
  }
  for (int i = 1; i < argc; ++i) {
    std::string arg = argv[i];
    auto need = [&](const char* flag) -> std::string {
      if (i + 1 >= argc) Die(std::string(flag) + " requires a value");
      return argv[++i];
    };
    if (arg == "--package") {
      package_path = need("--package");
    } else if (arg == "--spec") {
      spec_path = need("--spec");
    } else if (arg == "--ops") {
      ops_path = need("--ops");
    } else if (arg == "--runs") {
      runs = std::atoi(need("--runs").c_str());
    } else if (arg == "--device") {
      device_name = need("--device");
    } else {
      Die("unknown flag " + arg);
    }
  }
  if (package_path.empty() || spec_path.empty()) {
    Usage();
    return 1;
  }
  if (device_name != "cuda" && device_name != "cpu") {
    Die("--device takes cuda or cpu, got " + device_name);
  }
  const bool cuda = device_name == "cuda";
#ifndef GPUAB_WITH_CUDA
  if (cuda) Die("built without CUDA: only --device cpu runs here");
#endif

  // -- the operators, then the package ----------------------------------
  if (!ops_path.empty()) {
    if (dlopen(ops_path.c_str(), RTLD_NOW | RTLD_GLOBAL) == nullptr) {
      Die(std::string("dlopen failed: ") + dlerror());
    }
    std::printf("ops: %s\n", ops_path.c_str());
  }
  int devices = 1;
#ifdef GPUAB_WITH_CUDA
  if (cuda) {
    devices = static_cast<int>(c10::cuda::device_count());
    if (devices == 0) Die("no CUDA device");
  }
#endif
  std::printf("devices: %d addressable (%s)\n", devices, device_name.c_str());

  auto t_load = std::chrono::steady_clock::now();
  torch::inductor::AOTIModelPackageLoader loader(package_path);
  std::printf("load: %.1f ms\n", Ms(t_load));

  // -- seeded inputs -----------------------------------------------------
  const at::Device device = cuda ? at::Device(at::kCUDA, 0) : at::Device(at::kCPU);
  std::vector<InputSpec> specs = ParseSpec(spec_path);
  std::vector<at::Tensor> inputs;
  uint64_t rng = 42;
  for (const InputSpec& spec : specs) {
    at::Tensor host = at::empty(spec.dims, spec.is_i32 ? at::kInt : at::kFloat);
    const int64_t n = spec.elems();
    if (spec.is_i32) {
      // pjrt_runner's S32 rule: small non-negative ints.
      int32_t* p = host.data_ptr<int32_t>();
      for (int64_t j = 0; j < n; ++j) {
        p[j] = static_cast<int32_t>((NextRand(&rng) * 0.5f + 0.5f) * 1000.0f);
      }
    } else {
      float* p = host.data_ptr<float>();
      for (int64_t j = 0; j < n; ++j) p[j] = NextRand(&rng);
    }
    inputs.push_back(host.to(device));
  }

  // -- round trips: run, synchronise, copy output 0 back -----------------
  size_t num_outputs = 0;
  auto round_trip = [&](double* out_ms) {
    auto t0 = std::chrono::steady_clock::now();
    std::vector<at::Tensor> outputs = loader.run(inputs);
#ifdef GPUAB_WITH_CUDA
    if (cuda) c10::cuda::getCurrentCUDAStream(0).synchronize();
#endif
    if (outputs.empty()) Die("the package returned no output");
    at::Tensor host = outputs[0].to(at::kCPU).contiguous();
    *out_ms = Ms(t0);
    num_outputs = outputs.size();
    at::Tensor flat = host.to(at::kFloat).reshape({-1});
    const float* f = flat.data_ptr<float>();
    double checksum = 0.0;
    for (int64_t i = 0; i < flat.numel() && i < 64; ++i) checksum += f[i];
    return checksum;
  };

  double warm_ms = 0.0;
  const double checksum = round_trip(&warm_ms);
  std::printf("inputs: %zu uploaded, outputs: %zu\n", inputs.size(),
              num_outputs);
  std::printf("warmup: %.3f ms (output[0:64] checksum %.6f)\n", warm_ms,
              checksum);

  std::vector<double> latencies;
  for (int i = 0; i < runs; ++i) {
    double ms = 0.0;
    round_trip(&ms);
    latencies.push_back(ms);
  }
  std::printf(
      "runs: %d  p50: %.3f ms  p95: %.3f ms  min: %.3f ms  max: %.3f ms\n",
      runs, Percentile(latencies, 0.50), Percentile(latencies, 0.95),
      Percentile(latencies, 0.0), Percentile(latencies, 1.0));
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  // Line by line into a pipe too: a caller reads the warm-up line while
  // the timed runs go on.
  std::setvbuf(stdout, nullptr, _IOLBF, 0);
  try {
    return Run(argc, argv);
  } catch (const std::exception& e) {
    Die(std::string("failed: ") + e.what());
  }
}
