// The hand-written kernels as PyTorch operators: the `gpuab` library.
//
// Each operator calls one C entry of a kernel source of this directory
// (modal_bank.cu, iir.cu, conv1d.cu, fdtd3d.cu) on the current CUDA stream,
// so a CUDA graph captures it like any other launch. The schemas are
// functional: an operator allocates its outputs and its scratch and never
// writes an input. That lets torch.export trace a program that calls them
// and AOTInductor compile it into a package: the package calls the
// operator by name through the dispatcher, so a process with no Python in
// it (native_runner.cc) runs the kernels once it has loaded this library.
//
// The launch geometry comes from the caller, as ops/*.py computes it (the
// modal schedule, the cascade's step ranges, the FDTD route's ranges): an
// export bakes it into the program as constants, and the C entries refuse
// one that does not cover the shape. A nonzero return raises.
//
// Built by g++ (utils/native.py:build_ops) against PyTorch's headers. With
// GPUAB_WITH_CUDA the CUDA implementations are compiled in and the library
// links the kernels' shared libraries (utils/build.py); without it, on a
// machine with no CUDA toolkit, it holds the schemas alone. The plain
// PyTorch twins are registered for the CPU from Python (ops/gpuab.py), so a
// process without Python has no CPU implementation, and no fallback.

#include <torch/library.h>

#include <string>

#ifdef GPUAB_WITH_CUDA
#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>

#include <tuple>
#include <vector>

extern "C" {
int modal_bank_launch(const float* cos_w, const float* sin_w, const float* amp,
                      const float* re_in, const float* im_in, float* re_out,
                      float* im_out, float* partials, float* out, int m, int s,
                      int t_out, int track_major, int mpt, int grid, int passes,
                      void* stream);
int iir_biquad_launch(const float* x, const float* coeffs, const float* z_in,
                      float* y, float* z_out, int tracks, int s, void* stream);
int iir_cascade_launch(const float* x, const float* coeffs, const float* z_in,
                       float* y, float* z_out, int tracks, int s, int k,
                       int grid, int steady_end, int drain_end, int chunks,
                       void* stream);
int conv1d_direct_launch(const float* x, const float* ir, float* out,
                         int tracks, int s, int l, int bleed, void* stream);
int fdtd_div_cluster_launch(const float* src, const float* p_in,
                            const float* div_in, float* p_out, float* div_out,
                            float* out, int n, int s, int src_cell, int tracks,
                            int rcv_cell, float k1, float k2, float c6,
                            float absorb, float out_scale, const int* starts,
                            int blocks, void* stream);
int fdtd_div_planes_launch(const float* src, const float* p_in,
                           const float* div_in, float* p_out, float* div_out,
                           float* out, float* xch, int* flags, int n, int s,
                           int src_cell, int tracks, int rcv_cell, float k1,
                           float k2, float c6, float absorb, float out_scale,
                           const int* starts, int blocks, void* stream);
}

namespace {

using at::Tensor;

// Threads of an FDTD block and the plane route's flag stride (ints), as
// csrc/fdtd3d.cu and ops/fdtd3d.py have them.
constexpr int64_t kFdtdThreads = 1024;
constexpr int64_t kPlaneFlagStride = 32;

void check_input(const Tensor& t, const Tensor& like, const char* op,
                 const char* name) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device(), op, ": ", name,
              " must be on ", like.device(), ", got ", t.device());
  TORCH_CHECK(t.scalar_type() == at::kFloat, op, ": ", name,
              " must be float32, got ", t.scalar_type());
  TORCH_CHECK(t.is_contiguous(), op, ": ", name, " must be contiguous");
}

const float* in(const Tensor& t) { return t.const_data_ptr<float>(); }
float* out(Tensor& t) { return t.mutable_data_ptr<float>(); }

Tensor empty_f32(at::IntArrayRef shape, const Tensor& like) {
  return at::empty(shape, like.options().dtype(at::kFloat));
}

void* stream_of(const Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.device().index()).stream();
}

void raise_on(int err, const char* op) {
  TORCH_CHECK(err == 0, op, " failed: CUDA error ", err);
}

int as_int(int64_t v, const char* op, const char* name) {
  TORCH_CHECK(v >= 0 && v <= 0x7fffffff, op, ": ", name, " ", v,
              " out of range");
  return static_cast<int>(v);
}

std::tuple<Tensor, Tensor, Tensor> modal_bank_cuda(
    const Tensor& cos_w, const Tensor& sin_w, const std::optional<Tensor>& amp,
    const Tensor& re, const Tensor& im, int64_t buffer_size,
    int64_t output_tracks, bool track_major, bool keep_states,
    int64_t modes_per_thread, int64_t grid, int64_t passes) {
  const char* op = "gpuab::modal_bank_launch";
  for (const Tensor* t : {&cos_w, &sin_w, &re, &im}) {
    check_input(*t, re, op, "a table");
  }
  if (amp) check_input(*amp, re, op, "amp");
  c10::cuda::CUDAGuard guard(re.device());
  const int64_t m = re.numel();
  Tensor partials =
      empty_f32({grid * passes, buffer_size, output_tracks}, re);
  Tensor y = track_major ? empty_f32({output_tracks, buffer_size}, re)
                         : empty_f32({buffer_size, output_tracks}, re);
  Tensor re_o = keep_states ? at::empty_like(re) : empty_f32({0}, re);
  Tensor im_o = keep_states ? at::empty_like(im) : empty_f32({0}, re);
  raise_on(modal_bank_launch(
               in(cos_w), in(sin_w), amp ? in(*amp) : nullptr, in(re), in(im),
               keep_states ? out(re_o) : nullptr,
               keep_states ? out(im_o) : nullptr, out(partials), out(y),
               as_int(m, op, "M"), as_int(buffer_size, op, "S"),
               as_int(output_tracks, op, "T_out"), track_major ? 1 : 0,
               as_int(modes_per_thread, op, "modes_per_thread"),
               as_int(grid, op, "grid"), as_int(passes, op, "passes"),
               stream_of(re)),
           op);
  return {y, re_o, im_o};
}

std::tuple<Tensor, Tensor> iir_biquad_cuda(const Tensor& x,
                                           const Tensor& coeffs,
                                           const Tensor& state) {
  const char* op = "gpuab::iir_biquad_launch";
  check_input(x, x, op, "x");
  check_input(coeffs, x, op, "coeffs");
  check_input(state, x, op, "state");
  c10::cuda::CUDAGuard guard(x.device());
  Tensor y = at::empty_like(x);
  Tensor z = at::empty_like(state);
  raise_on(iir_biquad_launch(in(x), in(coeffs), in(state), out(y), out(z),
                             as_int(x.size(0), op, "tracks"),
                             as_int(x.size(1), op, "S"), stream_of(x)),
           op);
  return {y, z};
}

std::tuple<Tensor, Tensor> iir_cascade_cuda(
    const Tensor& x, const Tensor& coeffs, const Tensor& states, int64_t grid,
    int64_t steady_end, int64_t drain_end, int64_t chunks) {
  const char* op = "gpuab::iir_cascade_launch";
  check_input(x, x, op, "x");
  check_input(coeffs, x, op, "coeffs");
  check_input(states, x, op, "states");
  c10::cuda::CUDAGuard guard(x.device());
  Tensor y = at::empty_like(x);
  Tensor z = at::empty_like(states);
  raise_on(iir_cascade_launch(
               in(x), in(coeffs), in(states), out(y), out(z),
               as_int(x.size(0), op, "tracks"), as_int(x.size(1), op, "S"),
               as_int(coeffs.size(0), op, "K"), as_int(grid, op, "grid"),
               as_int(steady_end, op, "steady_end"),
               as_int(drain_end, op, "drain_end"),
               as_int(chunks, op, "chunks"), stream_of(x)),
           op);
  return {y, z};
}

Tensor conv1d_direct_cuda(const Tensor& x, const Tensor& ir, bool bleed) {
  const char* op = "gpuab::conv1d_direct_launch";
  check_input(x, x, op, "x");
  check_input(ir, x, op, "ir");
  c10::cuda::CUDAGuard guard(x.device());
  Tensor y = at::empty_like(x);
  raise_on(conv1d_direct_launch(in(x), in(ir), out(y),
                                as_int(x.size(0), op, "tracks"),
                                as_int(x.size(1), op, "S"),
                                as_int(ir.size(1), op, "L"), bleed ? 1 : 0,
                                stream_of(x)),
           op);
  return y;
}

// The divergence form on either route: `planes` the cooperative plane
// kernel (with its exchange buffer and flags as scratch), else the
// cluster kernel. src (s,) is the source row, p and div (n, n, n).
std::tuple<Tensor, Tensor, Tensor> fdtd_div_cuda(
    bool planes, const Tensor& src, const Tensor& p, const Tensor& div,
    int64_t tracks, int64_t src_cell, int64_t rcv_cell, double k1, double k2,
    double c6, double absorb, double out_scale, at::IntArrayRef starts) {
  const char* op = planes ? "gpuab::fdtd_div_planes_launch"
                          : "gpuab::fdtd_div_cluster_launch";
  check_input(src, p, op, "src");
  check_input(p, p, op, "p");
  check_input(div, p, op, "div");
  TORCH_CHECK(starts.size() >= 2, op, ": starts needs blocks + 1 entries");
  c10::cuda::CUDAGuard guard(p.device());
  const int64_t n = p.size(0);
  std::vector<int> cuts;
  for (int64_t v : starts) cuts.push_back(as_int(v, op, "a start"));
  const int blocks = static_cast<int>(cuts.size()) - 1;
  Tensor p_o = at::empty_like(p);
  Tensor div_o = at::empty_like(div);
  Tensor y = empty_f32({tracks, src.size(0)}, p);
  const int ni = as_int(n, op, "n");
  const int s = as_int(src.size(0), op, "S");
  const int t = as_int(tracks, op, "tracks");
  const int sc = as_int(src_cell, op, "src_cell");
  const int rc = as_int(rcv_cell, op, "rcv_cell");
  int err;
  if (planes) {
    // ops/fdtd3d.py:plane_stride, two parities of n + 2 slots.
    const int64_t stride = (n * n + 12 + kFdtdThreads + 3) / 4 * 4;
    Tensor xch = empty_f32({2 * (n + 2) * stride}, p);
    Tensor flags = at::empty({n * kPlaneFlagStride}, p.options().dtype(at::kInt));
    err = fdtd_div_planes_launch(
        in(src), in(p), in(div), out(p_o), out(div_o), out(y), out(xch),
        flags.mutable_data_ptr<int>(), ni, s, sc, t, rc,
        static_cast<float>(k1), static_cast<float>(k2), static_cast<float>(c6),
        static_cast<float>(absorb), static_cast<float>(out_scale), cuts.data(),
        blocks, stream_of(p));
  } else {
    err = fdtd_div_cluster_launch(
        in(src), in(p), in(div), out(p_o), out(div_o), out(y), ni, s, sc, t,
        rc, static_cast<float>(k1), static_cast<float>(k2),
        static_cast<float>(c6), static_cast<float>(absorb),
        static_cast<float>(out_scale), cuts.data(), blocks, stream_of(p));
  }
  raise_on(err, op);
  return {y, p_o, div_o};
}

std::tuple<Tensor, Tensor, Tensor> fdtd_div_cluster_cuda(
    const Tensor& src, const Tensor& p, const Tensor& div, int64_t tracks,
    int64_t src_cell, int64_t rcv_cell, double k1, double k2, double c6,
    double absorb, double out_scale, at::IntArrayRef starts) {
  return fdtd_div_cuda(false, src, p, div, tracks, src_cell, rcv_cell, k1, k2,
                       c6, absorb, out_scale, starts);
}

std::tuple<Tensor, Tensor, Tensor> fdtd_div_planes_cuda(
    const Tensor& src, const Tensor& p, const Tensor& div, int64_t tracks,
    int64_t src_cell, int64_t rcv_cell, double k1, double k2, double c6,
    double absorb, double out_scale, at::IntArrayRef starts) {
  return fdtd_div_cuda(true, src, p, div, tracks, src_cell, rcv_cell, k1, k2,
                       c6, absorb, out_scale, starts);
}

}  // namespace
#endif  // GPUAB_WITH_CUDA

TORCH_LIBRARY(gpuab, m) {
  m.def(
      "modal_bank_launch(Tensor cos_w, Tensor sin_w, Tensor? amp, Tensor re, "
      "Tensor im, int buffer_size, int output_tracks, bool track_major, "
      "bool keep_states, int modes_per_thread, int grid, int passes) -> "
      "(Tensor, Tensor, Tensor)");
  m.def(
      "iir_biquad_launch(Tensor x, Tensor coeffs, Tensor state) -> "
      "(Tensor, Tensor)");
  m.def(
      "iir_cascade_launch(Tensor x, Tensor coeffs, Tensor states, int grid, "
      "int steady_end, int drain_end, int chunks) -> (Tensor, Tensor)");
  m.def("conv1d_direct_launch(Tensor x, Tensor ir, bool bleed) -> Tensor");
  for (const char* name : {"fdtd_div_cluster_launch", "fdtd_div_planes_launch"}) {
    const std::string schema =
        std::string(name) +
        "(Tensor src, Tensor p, Tensor div, int tracks, int src_cell, "
        "int rcv_cell, float k1, float k2, float c6, float absorb, "
        "float out_scale, int[] starts) -> (Tensor, Tensor, Tensor)";
    m.def(schema.c_str());
  }
}

#ifdef GPUAB_WITH_CUDA
TORCH_LIBRARY_IMPL(gpuab, CUDA, m) {
  m.impl("modal_bank_launch", &modal_bank_cuda);
  m.impl("iir_biquad_launch", &iir_biquad_cuda);
  m.impl("iir_cascade_launch", &iir_cascade_cuda);
  m.impl("conv1d_direct_launch", &conv1d_direct_cuda);
  m.impl("fdtd_div_cluster_launch", &fdtd_div_cluster_cuda);
  m.impl("fdtd_div_planes_launch", &fdtd_div_planes_cuda);
}
#endif
