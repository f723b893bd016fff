// The hand-written kernels as PyTorch operators: the `gpuab` library.
//
// Each operator calls one C entry of a kernel source of this directory
// (modal_bank.cu, iir.cu, conv1d.cu, rndmem.cu, dwg.cu, fdtd3d.cu,
// speedoflight.cu) on the current CUDA stream, so a CUDA graph captures it
// like any other launch: every kernel of the package is launched through
// one of these operators. The schemas are functional, an operator
// allocating its outputs and its scratch, but for the DWG block, which
// updates its rails in place as its wrapper always has (Tensor(a!), no
// copy of ~0.5 GB of rails a block). That lets torch.export trace a
// program that calls them and AOTInductor compile it into a package: the
// package calls the operator by name through the dispatcher, so a process
// with no Python in it (native_runner.cc) runs the kernels once it has
// loaded this library.
//
// The launch geometry comes from the caller, as ops/*.py computes it (the
// modal schedule, the cascade's step ranges, the chain's route, the DWG
// segments, the FDTD route's ranges): an export bakes it into the program
// as constants, and the C entries refuse one that does not cover the
// shape. The FDTD per-track receivers' plane buckets are data, not
// geometry: an operator of their own computes them on the card
// (fdtd_receiver_buckets), so a program takes its receivers as an input.
// A nonzero return raises.
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

#include <cstdint>
#include <optional>
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
int modal_res_launch(const float* eps, const float* y_in, const float* q_in,
                     float* y_out, float* q_out, float* partials, float* out,
                     int m, int s, int t_out, int track_major, int mpt,
                     int grid, int passes, void* stream);
int iir_blockstate_launch(const float* x, const float* coeffs,
                          const float* taps, const float* u, const float* z_in,
                          float* y, float* z_out, int tracks, int s, int m,
                          void* stream);
int iir_cascade_chain_launch(const float* x, const float* coeffs,
                             const float* z_in, float* y, float* z_out,
                             int tracks, int s, int k, int route, int grid,
                             int chunks, void* stream);
int rndmem_gather_launch(const float* pool, const int* playheads, float* out,
                         long long pool_len, int tracks, int s, void* stream);
int dwg_block_launch(const float* x, float* fwd, float* bwd,
                     const int* lengths, const int* in_taps,
                     const int* out_taps, const float* gains,
                     const float* refls, const float* damps,
                     float* group_sums, float* out, int guides, int lmax,
                     int s, int segs, int groups, int update_blocks,
                     void* stream);
int fdtd_field_planes_launch(const float* src, const float* p_in,
                             const float* vx_in, const float* vy_in,
                             const float* vz_in, float* p_out, float* vx_out,
                             float* vy_out, float* vz_out, float* out,
                             float* xch, int* flags, const int* rcv_rows,
                             const int* order, const int* rcv_starts, int n,
                             int s, int src_cell, int tracks, int rcv_cell,
                             float k1, float k2, float absorb,
                             float out_scale, const int* starts, int blocks,
                             void* stream);
int fdtd_receiver_buckets_launch(const int* receivers, int tracks, int n,
                                 int* cells, int* order, int* starts,
                                 void* stream);
int fma_chain_launch(const float* x, float* out, long long n, int k, float m,
                     float c, void* stream);
int fma_vmem_launch(const float* x, float* out, long long n, int k, float m,
                    float c, void* stream);
}

namespace {

using at::Tensor;

// Threads of an FDTD block and the plane route's flag stride (ints), as
// csrc/fdtd3d.cu and ops/fdtd3d.py have them.
constexpr int64_t kFdtdThreads = 1024;
constexpr int64_t kPlaneFlagStride = 32;

void check_input(const Tensor& t, const Tensor& like, const char* op,
                 const char* name, at::ScalarType dtype = at::kFloat) {
  TORCH_CHECK(t.is_cuda() && t.device() == like.device(), op, ": ", name,
              " must be on ", like.device(), ", got ", t.device());
  TORCH_CHECK(t.scalar_type() == dtype, op, ": ", name, " must be ", dtype,
              ", got ", t.scalar_type());
  TORCH_CHECK(t.is_contiguous(), op, ": ", name, " must be contiguous");
}

const float* in(const Tensor& t) { return t.const_data_ptr<float>(); }
const int* in_i(const Tensor& t) { return t.const_data_ptr<int>(); }
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

// The schedule's ranges as the C entries take them, host ints.
std::vector<int> host_ints(at::IntArrayRef v, const char* op,
                           const char* name) {
  std::vector<int> out;
  for (int64_t x : v) out.push_back(as_int(x, op, name));
  return out;
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
  std::vector<int> cuts = host_ints(starts, op, "a start");
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

// The resonator form of the modal bank on (eps, y, q): (out, y', q'), the
// states empty (0,) tensors unless keep_states.
std::tuple<Tensor, Tensor, Tensor> modal_res_cuda(
    const Tensor& eps, const Tensor& y, const Tensor& q, int64_t buffer_size,
    int64_t output_tracks, bool track_major, bool keep_states,
    int64_t modes_per_thread, int64_t grid, int64_t passes) {
  const char* op = "gpuab::modal_res_launch";
  for (const Tensor* t : {&eps, &y, &q}) check_input(*t, y, op, "a table");
  c10::cuda::CUDAGuard guard(y.device());
  Tensor partials =
      empty_f32({grid * passes, buffer_size, output_tracks}, y);
  Tensor o = track_major ? empty_f32({output_tracks, buffer_size}, y)
                         : empty_f32({buffer_size, output_tracks}, y);
  Tensor y_o = keep_states ? at::empty_like(y) : empty_f32({0}, y);
  Tensor q_o = keep_states ? at::empty_like(q) : empty_f32({0}, y);
  raise_on(modal_res_launch(
               in(eps), in(y), in(q), keep_states ? out(y_o) : nullptr,
               keep_states ? out(q_o) : nullptr, out(partials), out(o),
               as_int(y.numel(), op, "M"), as_int(buffer_size, op, "S"),
               as_int(output_tracks, op, "T_out"), track_major ? 1 : 0,
               as_int(modes_per_thread, op, "modes_per_thread"),
               as_int(grid, op, "grid"), as_int(passes, op, "passes"),
               stream_of(y)),
           op);
  return {o, y_o, q_o};
}

std::tuple<Tensor, Tensor> iir_blockstate_cuda(const Tensor& x,
                                               const Tensor& coeffs,
                                               const Tensor& taps,
                                               const Tensor& u,
                                               const Tensor& state) {
  const char* op = "gpuab::iir_blockstate_launch";
  check_input(x, x, op, "x");
  check_input(coeffs, x, op, "coeffs");
  check_input(taps, x, op, "taps");
  check_input(u, x, op, "u");
  check_input(state, x, op, "state");
  c10::cuda::CUDAGuard guard(x.device());
  Tensor y = at::empty_like(x);
  Tensor z = at::empty_like(state);
  raise_on(iir_blockstate_launch(in(x), in(coeffs), in(taps), in(u),
                                 in(state), out(y), out(z),
                                 as_int(x.size(0), op, "tracks"),
                                 as_int(x.size(1), op, "S"),
                                 as_int(taps.size(0), op, "m"), stream_of(x)),
           op);
  return {y, z};
}

// route 0 TMA, 1 staged (ops/iir.py:chain_schedule); -1 takes the
// schedule's rule on this launch's pointer (a traced program, whose x has
// no address until it runs).
std::tuple<Tensor, Tensor> iir_cascade_chain_cuda(
    const Tensor& x, const Tensor& coeffs, const Tensor& states,
    int64_t route, int64_t grid, int64_t chunks) {
  const char* op = "gpuab::iir_cascade_chain_launch";
  check_input(x, x, op, "x");
  check_input(coeffs, x, op, "coeffs");
  check_input(states, x, op, "states");
  c10::cuda::CUDAGuard guard(x.device());
  Tensor y = at::empty_like(x);
  Tensor z = at::empty_like(states);
  if (route < 0) {
    const auto addr = reinterpret_cast<uintptr_t>(x.const_data_ptr());
    route = (x.size(1) % 4 == 0 && addr % 16 == 0) ? 0 : 1;
  }
  raise_on(iir_cascade_chain_launch(
               in(x), in(coeffs), in(states), out(y), out(z),
               as_int(x.size(0), op, "tracks"), as_int(x.size(1), op, "S"),
               as_int(coeffs.size(0), op, "K"), as_int(route, op, "route"),
               as_int(grid, op, "grid"), as_int(chunks, op, "chunks"),
               stream_of(x)),
           op);
  return {y, z};
}

Tensor rndmem_gather_cuda(const Tensor& pool, const Tensor& playheads,
                          int64_t samples) {
  const char* op = "gpuab::rndmem_gather_launch";
  check_input(pool, pool, op, "pool");
  check_input(playheads, pool, op, "playheads", at::kInt);
  c10::cuda::CUDAGuard guard(pool.device());
  Tensor y = empty_f32({samples, playheads.size(0)}, pool);
  raise_on(rndmem_gather_launch(in(pool), in_i(playheads), out(y),
                                pool.size(0),
                                as_int(playheads.size(0), op, "tracks"),
                                as_int(samples, op, "samples"),
                                stream_of(pool)),
           op);
  return y;
}

// The rails fwd and bwd are updated in place; the mono output is returned.
Tensor dwg_block_cuda(const Tensor& x, Tensor& fwd, Tensor& bwd,
                      const Tensor& lengths, const Tensor& in_taps,
                      const Tensor& out_taps, const Tensor& gains,
                      const Tensor& refl, const Tensor& damp,
                      int64_t segments, int64_t groups,
                      int64_t update_blocks) {
  const char* op = "gpuab::dwg_block_launch";
  check_input(x, x, op, "x");
  check_input(fwd, x, op, "fwd");
  check_input(bwd, x, op, "bwd");
  for (const Tensor* t : {&lengths, &in_taps, &out_taps}) {
    check_input(*t, x, op, "a tap or length table", at::kInt);
  }
  for (const Tensor* t : {&gains, &refl, &damp}) {
    check_input(*t, x, op, "a gain table");
  }
  c10::cuda::CUDAGuard guard(x.device());
  const int64_t s = x.size(0);
  Tensor group_sums = empty_f32({groups, s}, x);
  Tensor y = at::empty_like(x);
  raise_on(dwg_block_launch(
               in(x), out(fwd), out(bwd), in_i(lengths), in_i(in_taps),
               in_i(out_taps), in(gains), in(refl), in(damp),
               out(group_sums), out(y), as_int(fwd.size(0), op, "waveguides"),
               as_int(fwd.size(1), op, "Lmax"), as_int(s, op, "S"),
               as_int(segments, op, "segments"), as_int(groups, op, "groups"),
               as_int(update_blocks, op, "update_blocks"), stream_of(x)),
           op);
  return y;
}

// The per-track receivers bucketed by x-plane of an n^3 grid, on the
// card: (cells, order, starts), int32 (T,), (T,) and (n + 1,), as
// fdtd_field_planes_launch takes them (ops/fdtd3d.py:receiver_csr is the
// host reference). No receiver value raises: a cell outside the grid is
// wrapped once if negative, then clamped to the grid.
std::tuple<Tensor, Tensor, Tensor> fdtd_receiver_buckets_cuda(
    const Tensor& receivers, int64_t n) {
  const char* op = "gpuab::fdtd_receiver_buckets";
  check_input(receivers, receivers, op, "receivers", at::kInt);
  TORCH_CHECK(receivers.dim() == 1 && receivers.size(0) > 0, op,
              ": receivers must be (tracks,), got ", receivers.sizes());
  c10::cuda::CUDAGuard guard(receivers.device());
  Tensor cells = at::empty_like(receivers);
  Tensor order = at::empty_like(receivers);
  Tensor starts = at::empty({n + 1}, receivers.options());
  raise_on(fdtd_receiver_buckets_launch(
               in_i(receivers), as_int(receivers.size(0), op, "tracks"),
               as_int(n, op, "n"), cells.mutable_data_ptr<int>(),
               order.mutable_data_ptr<int>(), starts.mutable_data_ptr<int>(),
               stream_of(receivers)),
           op);
  return {cells, order, starts};
}

// The field form's plane kernel: (out, p', vx', vy', vz'). With rcv_cells,
// rcv_order and rcv_starts (fdtd_receiver_buckets' outputs, on the card)
// track t reads its own cell; without them every track reads rcv_cell.
std::tuple<Tensor, Tensor, Tensor, Tensor, Tensor> fdtd_field_planes_cuda(
    const Tensor& src, const Tensor& p, const Tensor& vx, const Tensor& vy,
    const Tensor& vz, const std::optional<Tensor>& rcv_cells,
    const std::optional<Tensor>& rcv_order,
    const std::optional<Tensor>& rcv_starts, int64_t tracks,
    int64_t src_cell, int64_t rcv_cell, double k1, double k2, double absorb,
    double out_scale, at::IntArrayRef starts) {
  const char* op = "gpuab::fdtd_field_planes_launch";
  check_input(src, p, op, "src");
  for (const Tensor* t : {&p, &vx, &vy, &vz}) {
    check_input(*t, p, op, "a field");
  }
  const int64_t n = p.size(0);
  const bool per_track = rcv_cells.has_value();
  TORCH_CHECK(per_track == rcv_order.has_value() &&
                  per_track == rcv_starts.has_value(),
              op, ": rcv_cells, rcv_order and rcv_starts come together");
  if (per_track) {
    check_input(*rcv_cells, p, op, "rcv_cells", at::kInt);
    check_input(*rcv_order, p, op, "rcv_order", at::kInt);
    check_input(*rcv_starts, p, op, "rcv_starts", at::kInt);
    TORCH_CHECK(rcv_cells->numel() == tracks && rcv_order->numel() == tracks,
                op, ": rcv_cells and rcv_order need ", tracks, " entries");
    TORCH_CHECK(rcv_starts->numel() == n + 1, op, ": rcv_starts needs ",
                n + 1, " entries, got ", rcv_starts->numel());
  }
  TORCH_CHECK(starts.size() >= 2, op, ": starts needs blocks + 1 entries");
  c10::cuda::CUDAGuard guard(p.device());
  std::vector<int> cuts = host_ints(starts, op, "a start");
  Tensor p_o = at::empty_like(p);
  Tensor vx_o = at::empty_like(vx);
  Tensor vy_o = at::empty_like(vy);
  Tensor vz_o = at::empty_like(vz);
  Tensor y = empty_f32({tracks, src.size(0)}, p);
  const int64_t stride = (n * n + 12 + kFdtdThreads + 3) / 4 * 4;
  Tensor xch = empty_f32({2 * (n + 2) * stride}, p);
  Tensor flags =
      at::empty({n * kPlaneFlagStride}, p.options().dtype(at::kInt));
  raise_on(fdtd_field_planes_launch(
               in(src), in(p), in(vx), in(vy), in(vz), out(p_o), out(vx_o),
               out(vy_o), out(vz_o), out(y), out(xch),
               flags.mutable_data_ptr<int>(),
               per_track ? in_i(*rcv_cells) : nullptr,
               per_track ? in_i(*rcv_order) : nullptr,
               per_track ? in_i(*rcv_starts) : nullptr, as_int(n, op, "n"),
               as_int(src.size(0), op, "S"), as_int(src_cell, op, "src_cell"),
               as_int(tracks, op, "tracks"), as_int(rcv_cell, op, "rcv_cell"),
               static_cast<float>(k1), static_cast<float>(k2),
               static_cast<float>(absorb), static_cast<float>(out_scale),
               cuts.data(), static_cast<int>(cuts.size()) - 1, stream_of(p)),
           op);
  return {y, p_o, vx_o, vy_o, vz_o};
}

// The speed-of-light chains: k passes of y <- y*m + c over a copy of x,
// in registers (vmem false) or through shared memory (vmem true).
Tensor fma_cuda(bool vmem, const Tensor& x, int64_t k, double m, double c) {
  const char* op = vmem ? "gpuab::fma_vmem_launch" : "gpuab::fma_chain_launch";
  check_input(x, x, op, "x");
  c10::cuda::CUDAGuard guard(x.device());
  Tensor y = at::empty_like(x);
  const auto launch = vmem ? fma_vmem_launch : fma_chain_launch;
  raise_on(launch(in(x), out(y), x.numel(), as_int(k, op, "k"),
                  static_cast<float>(m), static_cast<float>(c),
                  stream_of(x)),
           op);
  return y;
}

Tensor fma_chain_cuda(const Tensor& x, int64_t k, double m, double c) {
  return fma_cuda(false, x, k, m, c);
}

Tensor fma_vmem_cuda(const Tensor& x, int64_t k, double m, double c) {
  return fma_cuda(true, x, k, m, c);
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
  m.def(
      "modal_res_launch(Tensor eps, Tensor y, Tensor q, int buffer_size, "
      "int output_tracks, bool track_major, bool keep_states, "
      "int modes_per_thread, int grid, int passes) -> "
      "(Tensor, Tensor, Tensor)");
  m.def(
      "iir_blockstate_launch(Tensor x, Tensor coeffs, Tensor taps, Tensor u, "
      "Tensor state) -> (Tensor, Tensor)");
  m.def(
      "iir_cascade_chain_launch(Tensor x, Tensor coeffs, Tensor states, "
      "int route, int grid, int chunks) -> (Tensor, Tensor)");
  m.def(
      "rndmem_gather_launch(Tensor pool, Tensor playheads, int samples) -> "
      "Tensor");
  m.def(
      "dwg_block_launch(Tensor x, Tensor(a!) fwd, Tensor(b!) bwd, "
      "Tensor lengths, Tensor in_taps, Tensor out_taps, Tensor gains, "
      "Tensor refl, Tensor damp, int segments, int groups, "
      "int update_blocks) -> Tensor");
  m.def(
      "fdtd_field_planes_launch(Tensor src, Tensor p, Tensor vx, Tensor vy, "
      "Tensor vz, Tensor? rcv_cells, Tensor? rcv_order, Tensor? rcv_starts, "
      "int tracks, int src_cell, int rcv_cell, float k1, float k2, "
      "float absorb, float out_scale, int[] starts) -> "
      "(Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def(
      "fdtd_receiver_buckets(Tensor receivers, int n) -> "
      "(Tensor, Tensor, Tensor)");
  for (const char* name : {"fma_chain_launch", "fma_vmem_launch"}) {
    const std::string schema =
        std::string(name) + "(Tensor x, int k, float m, float c) -> Tensor";
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
  m.impl("modal_res_launch", &modal_res_cuda);
  m.impl("iir_blockstate_launch", &iir_blockstate_cuda);
  m.impl("iir_cascade_chain_launch", &iir_cascade_chain_cuda);
  m.impl("rndmem_gather_launch", &rndmem_gather_cuda);
  m.impl("dwg_block_launch", &dwg_block_cuda);
  m.impl("fdtd_field_planes_launch", &fdtd_field_planes_cuda);
  m.impl("fdtd_receiver_buckets", &fdtd_receiver_buckets_cuda);
  m.impl("fma_chain_launch", &fma_chain_cuda);
  m.impl("fma_vmem_launch", &fma_vmem_cuda);
}
#endif
