// Measurements behind PERF.md's account of the modal bank kernel
// (csrc/modal_bank.cu): the kernel pair as it shipped before its
// redesign, the redesigned kernel (included) and its variants in modes a
// thread and warps a block, all built into one library with a plain C
// interface. run.py (beside this file) builds it twice with nvcc, once
// with -DMODAL_PROFILE, which turns the redesigned kernel's MODAL_MARK
// hooks into clock64() phase sums, and drives both on one CUDA device.
// Nothing of the port loads this file.
//
// * old_modal_launch / old_res_launch: the 512-block, 8-warp,
//   8-modes-a-thread partials kernel with two __syncthreads() a 32-sample
//   chunk, and its 64-block reduce, as they were; old_modal_profile: the
//   same partials kernel with clock64() phase sums per warp.
// * modal_bank_launch / modal_res_launch (csrc/modal_bank.cu, included):
//   the kernel as shipped; under MODAL_PROFILE, with phase sums.
// * variant_launch: the shipped kernel's template at other (modes a
//   thread, rotation warps, fold warps), on the shipped schedule rule.
// * old_reduce_launch / new_reduce_launch: each reduce kernel alone.

#include <cuda_runtime.h>

#include <cstdint>

#ifdef MODAL_PROFILE
// 8 int64 a warp, block-major: [0] the warp's total cycles, [q] the
// cycles of phase q (1..6, see csrc/modal_bank.cu).
__device__ long long* g_modal_prof;

__device__ __forceinline__ void modal_mark(int q) {
    __shared__ long long last[32];
    __shared__ long long sums[32][8];
    if ((threadIdx.x & 31) != 0) return;
    const int warp = threadIdx.x >> 5;
    const long long now = clock64();
    if (q == 0) {
        for (int i = 1; i < 8; ++i) sums[warp][i] = 0;
        sums[warp][0] = now;
        last[warp] = now;
        return;
    }
    sums[warp][q] += now - last[warp];
    last[warp] = now;
    if (q == 7) {
        long long* dst = g_modal_prof + (static_cast<long long>(blockIdx.x) *
                                         (blockDim.x >> 5) + warp) * 8;
        dst[0] = now - sums[warp][0];
        for (int i = 1; i < 8; ++i) dst[i] = sums[warp][i];
    }
}
#define MODAL_MARK(q) modal_mark(q)
#endif

#include "../../gpuaudiobench_tpu_torch/csrc/modal_bank.cu"

namespace old_form {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kModesPerThread = 8;
constexpr int kChunk = 32;

long long num_warps(int m, int t_out) {
    const long long w = row_width(t_out);
    const long long tiles = (m + kModesPerThread * w - 1) / (kModesPerThread * w);
    return tiles * (w / 32);
}

int num_blocks(int m, int t_out) {
    return static_cast<int>((num_warps(m, t_out) + kWarps - 1) / kWarps);
}

// kProf adds clock64() phase sums per warp (lane 0 writes 8 int64 at
// prof + 8 * (block * 8 + warp)): [0] table loads, [1] rotation and
// lane_sums stores, [2] first barrier, [3] fold and partial stores, [4]
// second barrier, [5] state stores, [6] total.
template <bool kRes, bool kProf = false>
__global__ void __launch_bounds__(kThreads)
modal_bank_partials(const float* __restrict__ a_in,
                    const float* __restrict__ b_in,
                    const float* __restrict__ amp,
                    const float* __restrict__ s0_in,
                    const float* __restrict__ s1_in,
                    float* __restrict__ s0_out,
                    float* __restrict__ s1_out,
                    float* __restrict__ partials,
                    int m, int s, int t_out, int row_w,
                    long long* __restrict__ prof = nullptr) {
    long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    const long long start = kProf ? clock64() : 0;
    long long ck = start;
    auto mark = [&](int q) {
        if constexpr (kProf) {
            const long long now = clock64();
            ph[q] += now - ck;
            ck = now;
        }
    };
    __shared__ float lane_sums[kWarps][kChunk][32];
    __shared__ int warp_shift[kWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int cols = row_w / 32;
    const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
    const int col = static_cast<int>(g % cols);
    const long long base = (g / cols) * kModesPerThread * row_w + 32LL * col;
    if (lane == 0) warp_shift[warp] = (32 * col) % t_out;

    float a[kModesPerThread], b[kModesPerThread];
    float s0[kModesPerThread], s1[kModesPerThread];
#pragma unroll
    for (int k = 0; k < kModesPerThread; ++k) {
        const long long mode = base + static_cast<long long>(k) * row_w + lane;
        if (mode < m) {
            a[k] = a_in[mode];
            b[k] = kRes ? 0.f : b_in[mode];
            s0[k] = s0_in[mode];
            s1[k] = s1_in[mode];
            if (!kRes && amp != nullptr) {
                const float am = amp[mode];
                s0[k] = am * s0[k];
                s1[k] = am * s1[k];
            }
        } else {
            a[k] = kRes ? 0.f : 1.f;
            b[k] = 0.f;
            s0[k] = 0.f;
            s1[k] = 0.f;
        }
    }
    mark(0);

    float* block_partials = partials + static_cast<size_t>(blockIdx.x) * s * t_out;
    for (int n0 = 0; n0 < s; n0 += kChunk) {
        const int len = min(kChunk, s - n0);
#pragma unroll 4
        for (int j = 0; j < len; ++j) {
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < kModesPerThread; ++k) {
                if (kRes) {
                    s1[k] = __fsub_rn(s1[k], __fmul_rn(a[k], s0[k]));
                    s0[k] = __fadd_rn(s0[k], __fmul_rn(a[k], s1[k]));
                    acc += s0[k];
                } else {
                    const float r = s0[k] * a[k] - s1[k] * b[k];
                    s1[k] = s0[k] * b[k] + s1[k] * a[k];
                    s0[k] = r;
                    acc += r;
                }
            }
            lane_sums[warp][j][lane] = acc;
        }
        mark(1);
        __syncthreads();
        mark(2);
        for (int e = threadIdx.x; e < len * t_out; e += kThreads) {
            const int j = e / t_out;
            const int t = e - j * t_out;
            float sum = 0.f;
            for (int w = 0; w < kWarps; ++w) {
                int l = t - warp_shift[w];
                if (l < 0) l += t_out;
                for (; l < 32; l += t_out) sum += lane_sums[w][j][l];
            }
            block_partials[static_cast<size_t>(n0 + j) * t_out + t] = sum;
        }
        mark(3);
        __syncthreads();
        mark(4);
    }

    if (s0_out != nullptr) {
#pragma unroll
        for (int k = 0; k < kModesPerThread; ++k) {
            const long long mode = base + static_cast<long long>(k) * row_w + lane;
            if (mode < m) {
                s0_out[mode] = s0[k];
                s1_out[mode] = s1[k];
            }
        }
    }
    mark(5);
    if constexpr (kProf) {
        if (lane == 0) {
            long long* dst = prof + (static_cast<long long>(blockIdx.x) * kWarps + warp) * 8;
            for (int q = 0; q < 6; ++q) dst[q] = ph[q];
            dst[6] = clock64() - start;
        }
    }
}

__global__ void modal_bank_reduce(const float* __restrict__ partials,
                                  float* __restrict__ out,
                                  int n_blocks, int s, int t_out,
                                  int track_major) {
    const int total = s * t_out;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= total) return;
    float sum = 0.f;
#pragma unroll 8
    for (int b = 0; b < n_blocks; ++b) {
        sum += partials[static_cast<size_t>(b) * total + e];
    }
    const int n = e / t_out;
    const int t = e - n * t_out;
    out[track_major ? static_cast<size_t>(t) * s + n : static_cast<size_t>(e)] = sum;
}

int reduce(const float* partials, float* out, int n_blocks, int s, int t_out,
           int track_major, cudaStream_t st) {
    const int total = s * t_out;
    modal_bank_reduce<<<(total + 255) / 256, 256, 0, st>>>(
        partials, out, n_blocks, s, t_out, track_major);
    return static_cast<int>(cudaGetLastError());
}

template <bool kRes>
int launch(const float* a, const float* b, const float* amp,
           const float* s0_in, const float* s1_in, float* s0_out,
           float* s1_out, float* partials, float* out, int m, int s,
           int t_out, int track_major, long long* prof, void* stream) {
    if (m <= 0 || s <= 0 || t_out <= 0 || m % t_out != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = num_blocks(m, t_out);
    if (prof != nullptr) {
        modal_bank_partials<kRes, true><<<blocks, kThreads, 0, st>>>(
            a, b, amp, s0_in, s1_in, s0_out, s1_out, partials, m, s, t_out,
            row_width(t_out), prof);
    } else {
        modal_bank_partials<kRes><<<blocks, kThreads, 0, st>>>(
            a, b, amp, s0_in, s1_in, s0_out, s1_out, partials, m, s, t_out,
            row_width(t_out));
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return reduce(partials, out, blocks, s, t_out, track_major, st);
}

}  // namespace old_form

namespace {

// The shipped template at other geometries: (modes a thread, rotation
// warps, fold warps).
template <int Mpt, int Warps, int FoldWarps>
int run_variant(const float* cos_w, const float* sin_w, const float* re_in,
                const float* im_in, float* re_out, float* im_out,
                float* partials, float* out, int m, int s, int t_out,
                int* grid_passes, cudaStream_t st) {
    const int cap = capacity<false, Mpt, Warps, FoldWarps>();
    if (cap < 0) return -cap;
    const long long tiles = num_tiles(m, t_out, Mpt);
    const int grid = static_cast<int>(tiles < cap ? tiles : cap);
    const long long per_block = (tiles + grid - 1) / grid;
    const int passes = static_cast<int>((per_block + Warps - 1) / Warps);
    grid_passes[0] = grid;
    grid_passes[1] = passes;
    if (partials == nullptr) return 0;  // the schedule only
    return launch_mpt<false, Mpt, Warps, FoldWarps>(
        cos_w, sin_w, nullptr, re_in, im_in, re_out, im_out, partials, out, m, s,
        t_out, 0, grid, passes, st);
}

}  // namespace

extern "C" {

// The old pair, as modal_bank_launch was: partials holds
// old_modal_num_blocks(m, t_out) (s, t_out) partials.
int old_modal_num_blocks(int m, int t_out) { return old_form::num_blocks(m, t_out); }

int old_modal_launch(const float* cos_w, const float* sin_w, const float* amp,
                     const float* re_in, const float* im_in, float* re_out,
                     float* im_out, float* partials, float* out, int m, int s,
                     int t_out, int track_major, void* stream) {
    return old_form::launch<false>(cos_w, sin_w, amp, re_in, im_in, re_out,
                                   im_out, partials, out, m, s, t_out,
                                   track_major, nullptr, stream);
}

int old_res_launch(const float* eps, const float* y_in, const float* q_in,
                   float* y_out, float* q_out, float* partials, float* out,
                   int m, int s, int t_out, int track_major, void* stream) {
    return old_form::launch<true>(eps, nullptr, nullptr, y_in, q_in, y_out,
                                  q_out, partials, out, m, s, t_out,
                                  track_major, nullptr, stream);
}

// The old rotation pair with phase sums: prof holds 8 int64 for each of
// the old_modal_num_blocks x 8 warps.
int old_modal_profile(const float* cos_w, const float* sin_w,
                      const float* re_in, const float* im_in, float* re_out,
                      float* im_out, float* partials, float* out, int m, int s,
                      int t_out, long long* prof, void* stream) {
    return old_form::launch<false>(cos_w, sin_w, nullptr, re_in, im_in, re_out,
                                   im_out, partials, out, m, s, t_out, 0, prof,
                                   stream);
}

// Each reduce kernel alone, over n (s, t_out) partials, reps launches in
// a row (so that the host's launch time stays out of a CUDA-event time).
int old_reduce_launch(const float* partials, float* out, int n, int s,
                      int t_out, int reps, void* stream) {
    int err = 0;
    for (int r = 0; r < reps && err == 0; ++r) {
        err = old_form::reduce(partials, out, n, s, t_out, 0,
                               static_cast<cudaStream_t>(stream));
    }
    return err;
}

int new_reduce_launch(const float* partials, float* out, int n, int s,
                      int t_out, int reps, void* stream) {
    const int total = s * t_out;
    for (int r = 0; r < reps; ++r) {
        modal_bank_reduce<<<(total + kReduceThreads - 1) / kReduceThreads,
                            kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            partials, out, n, s, t_out, 0);
    }
    return static_cast<int>(cudaGetLastError());
}

// Blocks an SM of the old partials kernel (occupancy API).
int old_modal_occupancy() {
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, old_form::modal_bank_partials<false>, old_form::kThreads, 0);
    return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}

// variant 0..3: (modes a thread, rotation warps, fold warps) = (16, 16,
// 2), (16, 16, 4), (32, 8, 2), (21, 12, 2). With partials null, only
// writes the schedule (grid, passes) to grid_passes.
int variant_launch(int variant, const float* cos_w, const float* sin_w,
                   const float* re_in, const float* im_in, float* re_out,
                   float* im_out, float* partials, float* out, int m, int s,
                   int t_out, int* grid_passes, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VARIANT(V, P, W, F)                                                      \
    case V:                                                                      \
        return run_variant<P, W, F>(cos_w, sin_w, re_in, im_in, re_out, im_out, \
                                    partials, out, m, s, t_out, grid_passes, st);
    switch (variant) {
        VARIANT(0, 16, 16, 2) VARIANT(1, 16, 16, 4) VARIANT(2, 32, 8, 2)
        VARIANT(3, 21, 12, 2)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef VARIANT
}

// Where the MODAL_PROFILE build writes its phase sums (8 int64 a warp of
// the grid); 0 in the plain build, which has no phase sums.
int modal_prof_set(long long* prof) {
#ifdef MODAL_PROFILE
    return static_cast<int>(cudaMemcpyToSymbol(g_modal_prof, &prof, sizeof(prof)));
#else
    (void)prof;
    return static_cast<int>(cudaErrorNotSupported);
#endif
}

}  // extern "C"
