// Measurements behind PERF.md's account of the systolic biquad cascade
// (csrc/iir.cu): the kernel as it shipped before its redesign, the
// redesigned kernel (included) and its variants in warps a block, ring
// depth and steady unroll, all built into one library with a plain C
// interface. run.py (beside this file) builds it twice with nvcc, once
// with -DCASCADE_PROFILE, which turns the redesigned kernel's
// CASCADE_MARK hooks into clock64() phase sums, and drives both on one
// CUDA device. Nothing of the port loads this file.
//
// * old_cascade_launch: the one-thread-a-track kernel, 128 tracks a
//   block, two tiles through __syncthreads() per 32-step chunk, the live
//   mask on every (step, stage), as it was (K = 1, 2, 10, 16);
//   old_cascade_profile: the same at K = 10 with clock64() phase sums.
// * iir_cascade_launch (csrc/iir.cu, included): the kernel as shipped;
//   under CASCADE_PROFILE, with phase sums (cascade_prof_set).
// * variant_launch: the shipped kernel's template at K = 10 with other
//   (warps a block, ring depth, steady quads a pass), on the same
//   schedule rule.

#include <cuda_runtime.h>

#include <cstdint>

#ifdef CASCADE_PROFILE
// 8 int64 a warp, block-major: [0] the warp's total cycles, [q] the
// cycles of phase q (1..7, see csrc/iir.cu).
__device__ long long* g_cascade_prof;

__device__ __forceinline__ void cascade_mark(int q) {
    __shared__ long long last[8];
    __shared__ long long sums[8][8];
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
        long long* dst = g_cascade_prof + (static_cast<long long>(blockIdx.x) *
                                           (blockDim.x >> 5) + warp) * 8;
        dst[0] = now - sums[warp][0];
        for (int i = 1; i < 8; ++i) dst[i] = sums[warp][i];
    }
}
#define CASCADE_MARK(q) cascade_mark(q)
#endif

#include "../../gpuaudiobench_tpu_torch/csrc/iir.cu"

namespace old_form {

// kProf adds clock64() phase sums per warp (lane 0 writes 8 int64 at
// prof + 8 * (block * 4 + warp)): [0] state loads, [1] tile loads, [2]
// the three barriers, [3] steps, [4] tile stores, [5] state stores, [6]
// total.
template <int K, bool kProf = false>
__global__ void __launch_bounds__(kTracks)
iir_cascade_systolic_kernel(const float* __restrict__ x,
                            const float* __restrict__ coeffs,
                            const float* __restrict__ z_in,
                            float* __restrict__ y, float* __restrict__ z_out,
                            int tracks, int s, long long* prof) {
    __shared__ float in_tile[kTracks][kPitch];
    __shared__ float out_tile[kTracks][kPitch];
    long long ph[7] = {0, 0, 0, 0, 0, 0, 0};
    long long t_start = 0, t_last = 0;
    auto mark = [&](int q) {
        if (kProf) {
            const long long now = clock64();
            ph[q] += now - t_last;
            t_last = now;
        }
    };
    if (kProf) t_start = t_last = clock64();
    const long long t0 = static_cast<long long>(blockIdx.x) * kTracks;
    const long long t = t0 + threadIdx.x;
    const bool live = t < tracks;
    Coeffs c[K];
    float z1[K], z2[K], ylast[K];
    load_stages<K>(coeffs, z_in, t, tracks, live, c, z1, z2);
#pragma unroll
    for (int k = 0; k < K; ++k) ylast[k] = 0.f;
    mark(0);

    // Step t works on input sample t; stage K-1 emits sample t - (K-1).
    const int steps = s + K - 1;
    for (int n0 = 0; n0 < steps; n0 += kChunk) {
        const int len = min(kChunk, steps - n0);
        load_tile<kBatch>(in_tile, x, t0, tracks, s, n0, min(len, max(s - n0, 0)));
        mark(1);
        __syncthreads();
        mark(2);
        const float* in_row = in_tile[threadIdx.x];
        float* out_row = out_tile[threadIdx.x];
        for (int j = 0; j < len; ++j) {
            const int step = n0 + j;
            const float xin = in_row[j];  // 0 once step >= s (stage 0 dead)
            // Stages from last to first, so ylast[k-1] is still the value
            // stage k-1 produced on the previous step.
#pragma unroll
            for (int k = K - 1; k >= 0; --k) {
                const float v = (k == 0) ? xin : ylast[k - 1];
                const float w = v - c[k].a1 * z1[k] - c[k].a2 * z2[k];
                const float out = c[k].b0 * w + c[k].b1 * z1[k] + c[k].b2 * z2[k];
                const int n = step - k;
                if (n >= 0 && n < s) {
                    z2[k] = z1[k];
                    z1[k] = w;
                }
                ylast[k] = out;
            }
            out_row[j] = ylast[K - 1];
        }
        mark(3);
        __syncthreads();
        mark(2);
        // out_tile[r][j] is output sample n0 + j - (K - 1).
        store_tile(y, out_tile, t0, tracks, s, n0 - (K - 1), len);
        mark(4);
        __syncthreads();
        mark(2);
    }
    if (live) store_stages<K>(z_out, t, tracks, z1, z2);
    mark(5);
    if (kProf && (threadIdx.x & 31) == 0) {
        long long* dst = prof + (static_cast<long long>(blockIdx.x) * 4 + (threadIdx.x >> 5)) * 8;
        for (int i = 0; i < 6; ++i) dst[i] = ph[i];
        dst[6] = t_last - t_start;
    }
}

}  // namespace old_form

namespace {

template <int K, int kW, int kR, int kU>
int systolic_on_rule(const float* x, const float* coeffs, const float* z_in, float* y,
                     float* z_out, int tracks, int s, cudaStream_t st) {
    const int lag = K - 1;
    const int steady_quads = s - lag >= 0 ? (s - lag) / 4 : 0;
    const int grid = (tracks + 32 * kW - 1) / (32 * kW);
    return static_cast<int>(launch_systolic<K, kW, kR, kU>(
        x, coeffs, z_in, y, z_out, tracks, s, grid, lag + 4 * steady_quads,
        lag + 4 * ((s + 3) / 4), (s + 31) / 32, st));
}

template <int K, int kW, int kR, int kU>
int occupancy() {
    constexpr int bytes = kW * kR * kCsTile * static_cast<int>(sizeof(float));
    auto kernel = iir_cascade_systolic_kernel<K, kW, kR, kU>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    }
    int n = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kW * 32, bytes);
    }
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

extern "C" {

int old_cascade_launch(const float* x, const float* coeffs, const float* z_in, float* y,
                       float* z_out, int tracks, int s, int k, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = grid_for(tracks, kTracks);
    switch (k) {
#define OLD_CASE(N)                                                                    \
    case N:                                                                            \
        old_form::iir_cascade_systolic_kernel<N><<<blocks, kTracks, 0, st>>>(          \
            x, coeffs, z_in, y, z_out, tracks, s, nullptr);                            \
        break;
        OLD_CASE(1) OLD_CASE(2) OLD_CASE(10) OLD_CASE(16)
#undef OLD_CASE
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// prof: 8 int64 per warp, (tracks / 32) warps.
int old_cascade_profile(const float* x, const float* coeffs, const float* z_in, float* y,
                        float* z_out, int tracks, int s, long long* prof, void* stream) {
    old_form::iir_cascade_systolic_kernel<10, true>
        <<<grid_for(tracks, kTracks), kTracks, 0, static_cast<cudaStream_t>(stream)>>>(
            x, coeffs, z_in, y, z_out, tracks, s, prof);
    return static_cast<int>(cudaGetLastError());
}

// Blocks an SM (occupancy API): old kernel (128 threads) and shipped
// kernel (kCsWarps warps, its dynamic shared memory) at depth k.
int old_cascade_occupancy(int k) {
    int n = 0;
    cudaError_t err = cudaErrorInvalidValue;
    switch (k) {
        case 1: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, old_form::iir_cascade_systolic_kernel<1>, kTracks, 0); break;
        case 10: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, old_form::iir_cascade_systolic_kernel<10>, kTracks, 0); break;
        case 16: err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, old_form::iir_cascade_systolic_kernel<16>, kTracks, 0); break;
        default: break;
    }
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

int new_cascade_occupancy(int k) {
    switch (k) {
        case 1: return occupancy<1, kCsWarps, kCsRing, kCsUnroll>();
        case 10: return occupancy<10, kCsWarps, kCsRing, kCsUnroll>();
        case 16: return occupancy<16, kCsWarps, kCsRing, kCsUnroll>();
        default: return -1;
    }
}

// Variants at K = 10: 0 (4 warps, ring 4), 1 (8 warps, ring 3), 2 (2
// warps, ring 3), 3 (4 warps, ring 3, two steady quads a pass). Returns
// blocks an SM for the variant when x is null.
int variant_launch(int v, const float* x, const float* coeffs, const float* z_in, float* y,
                   float* z_out, int tracks, int s, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VARIANT(W, R, U)                                                                 \
    return x ? systolic_on_rule<10, W, R, U>(x, coeffs, z_in, y, z_out, tracks, s, st)   \
             : occupancy<10, W, R, U>();
    switch (v) {
        case 0: VARIANT(4, 4, 1)
        case 1: VARIANT(8, 3, 1)
        case 2: VARIANT(2, 3, 1)
        case 3: VARIANT(4, 3, 2)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef VARIANT
}

#ifdef CASCADE_PROFILE
int cascade_prof_set(long long* p) {
    return static_cast<int>(cudaMemcpyToSymbol(g_cascade_prof, &p, sizeof(p)));
}
#endif

}  // extern "C"
