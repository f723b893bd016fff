// Modal phasor bank for Hopper (sm_90a), bound through a plain C
// interface (gpuaudiobench_tpu_torch/utils/build.py loads it with ctypes).
//
// Replaces gpuaudiobench_tpu/ops/modal_pallas.py:_modal_kernel (reached
// through _modal_folded). Per mode m the amp-prefolded phasor (re, im)
// rotates by (cos w, sin w) once per sample,
//     re' = re*c - im*s,   im' = re*s + im*c,
// and Re(state) is summed onto output track m mod T_out. The kernel
// writes out (S, T_out) sample-major (or (T_out, S) when asked) and,
// when given somewhere to put them, the final rotated states.
//
// What bounds it: at 1,048,576 modes x 512 samples the bank issues about
// 5 FP32 instructions per mode-sample (2 multiplies + 2 FMAs for the
// rotation, 1 add for the fold) against 16 MiB of mode tables and states
// read and 8 MiB of states written per block: about 2.7 G instructions
// over 24 MiB, so it is compute-bound, not memory-bound. The design keeps
// the FP32 pipes fed and memory out of the sample loop:
//   * Each thread loads its modes' cos, sin, re and im once, runs all S
//     samples with the phasors in registers, and stores re', im' once
//     (what the VMEM-resident tile does on the TPU).
//   * Lane l of a warp owns modes warp_base + 32*k + l with
//     warp_base % 32 == 0, so every mode of a thread folds onto track
//     l mod T_out (T_out divides 32): the per-sample partial of a thread
//     belongs to exactly one track, needs no shuffle, and the loads are
//     coalesced.
//   * No float atomics: the warps of a block are summed in a fixed order
//     through shared memory into one (S, T_out) partial per block, and a
//     second kernel sums the partials in block order. The result is
//     deterministic from run to run.
//
// Rounding: nvcc contracts re*c - im*s into an FMA by default, which
// rounds differently from the golden's separate f32 multiplies. The
// difference stays far inside the bank's 1e-4 relative-to-peak tolerance
// (models/modal.py), so contraction is left on rather than paying for
// -fmad=false.
//
// Left for later tuning: modes per thread, block size against the 132
// SMs, and a persistent grid that would shrink the partials.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kModesPerThread = 8;
constexpr int kModesPerWarp = 32 * kModesPerThread;
constexpr int kModesPerBlock = kWarps * kModesPerWarp;
constexpr int kChunk = 32;  // samples per shared-memory round

__global__ void __launch_bounds__(kThreads)
modal_bank_partials(const float* __restrict__ cos_w,
                    const float* __restrict__ sin_w,
                    const float* __restrict__ amp,
                    const float* __restrict__ re_in,
                    const float* __restrict__ im_in,
                    float* __restrict__ re_out,
                    float* __restrict__ im_out,
                    float* __restrict__ partials,
                    int m, int s, int t_out) {
    __shared__ float lane_sums[kWarps][kChunk][32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long warp_base = static_cast<long long>(blockIdx.x) * kModesPerBlock
                                + static_cast<long long>(warp) * kModesPerWarp;

    // Modes past the ragged edge rotate a zero phasor by a unit angle:
    // they add nothing and are never stored.
    float c[kModesPerThread], sn[kModesPerThread];
    float re[kModesPerThread], im[kModesPerThread];
#pragma unroll
    for (int k = 0; k < kModesPerThread; ++k) {
        const long long mode = warp_base + 32 * k + lane;
        if (mode < m) {
            c[k] = cos_w[mode];
            sn[k] = sin_w[mode];
            re[k] = re_in[mode];
            im[k] = im_in[mode];
            if (amp != nullptr) {  // fold amp into the phasor (rotation is linear)
                const float a = amp[mode];
                re[k] = a * re[k];
                im[k] = a * im[k];
            }
        } else {
            c[k] = 1.f;
            sn[k] = 0.f;
            re[k] = 0.f;
            im[k] = 0.f;
        }
    }

    float* block_partials = partials + static_cast<size_t>(blockIdx.x) * s * t_out;
    const int folds = 32 / t_out;
    for (int n0 = 0; n0 < s; n0 += kChunk) {
        const int len = min(kChunk, s - n0);
#pragma unroll 4
        for (int j = 0; j < len; ++j) {
            float acc = 0.f;
#pragma unroll
            for (int k = 0; k < kModesPerThread; ++k) {
                const float r = re[k] * c[k] - im[k] * sn[k];
                im[k] = re[k] * sn[k] + im[k] * c[k];
                re[k] = r;
                acc += r;
            }
            lane_sums[warp][j][lane] = acc;
        }
        __syncthreads();
        // Entry (j, t): warps in order, then the lanes l = t + f*t_out.
        for (int e = threadIdx.x; e < len * t_out; e += kThreads) {
            const int j = e / t_out;
            const int t = e - j * t_out;
            float sum = 0.f;
            for (int w = 0; w < kWarps; ++w) {
                for (int f = 0; f < folds; ++f) {
                    sum += lane_sums[w][j][t + f * t_out];
                }
            }
            block_partials[static_cast<size_t>(n0 + j) * t_out + t] = sum;
        }
        __syncthreads();
    }

    if (re_out != nullptr) {
#pragma unroll
        for (int k = 0; k < kModesPerThread; ++k) {
            const long long mode = warp_base + 32 * k + lane;
            if (mode < m) {
                re_out[mode] = re[k];
                im_out[mode] = im[k];
            }
        }
    }
}

// out[n, t] (or out[t, n] when track_major) = sum over blocks b, in order,
// of partials[b, n, t].
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

}  // namespace

extern "C" {

// Number of (S, T_out) partials the wrapper allocates for m modes.
int modal_bank_num_blocks(int m) {
    return (m + kModesPerBlock - 1) / kModesPerBlock;
}

// amp may be null (states already amp-prefolded); re_out and im_out may
// both be null (states not wanted). No output may alias an input (the
// pointers are __restrict__). Returns cudaGetLastError() after the
// launches (0 on success).
int modal_bank_launch(const float* cos_w, const float* sin_w,
                      const float* amp, const float* re_in,
                      const float* im_in, float* re_out, float* im_out,
                      float* partials, float* out,
                      int m, int s, int t_out, int track_major,
                      void* stream) {
    if (m <= 0 || s <= 0 || t_out <= 0 || 32 % t_out != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = modal_bank_num_blocks(m);
    modal_bank_partials<<<blocks, kThreads, 0, st>>>(
        cos_w, sin_w, amp, re_in, im_in, re_out, im_out, partials, m, s, t_out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int total = s * t_out;
    const int threads = 256;
    modal_bank_reduce<<<(total + threads - 1) / threads, threads, 0, st>>>(
        partials, out, blocks, s, t_out, track_major);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
