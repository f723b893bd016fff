// Modal bank for Hopper (sm_90a), in both of its forms, bound through a
// plain C interface (gpuaudiobench_tpu_torch/utils/build.py loads it with
// ctypes).
//
// * Rotation form, replacing gpuaudiobench_tpu/ops/modal_pallas.py:
//   _modal_kernel (reached through _modal_folded). Per mode m the
//   amp-prefolded phasor (re, im) rotates by (cos w, sin w) once per
//   sample,
//       re' = re*c - im*s,   im' = re*s + im*c,
//   and Re(state) is summed onto output track m mod T_out.
// * Gordon-Smith resonator form, replacing _modal_kernel_res (reached
//   through modal_res_step). Per mode the state (y, q) takes two
//   dependent shears per sample,
//       q' = q - eps*y,   y' = y + eps*q',
//   and y' is summed onto track m mod T_out.
// Both write out (S, T_out) sample-major (or (T_out, S) when asked) and,
// when given somewhere to put them, the final states, so blocks chain.
//
// What bounds them: at 1,048,576 modes x 512 samples the rotation issues
// about 5 FP32 instructions per mode-sample (2 multiplies + 2 FMAs, 1 add
// for the fold) against 16 MiB of mode tables and states read and 8 MiB
// of states written per block: about 2.7 G instructions over 24 MiB, so
// it is compute-bound, not memory-bound. The resonator issues 5 as well
// (see Rounding). The design keeps the FP32 pipes fed and memory out of
// the sample loop:
//   * Each thread loads its modes' tables and states once, runs all S
//     samples with the states in registers, and stores them once (what
//     the VMEM-resident tile does on the TPU).
//   * The modes are laid out as rows of width W = lcm(32, T_out). Warp g
//     owns the 32 columns 32*(g mod W/32) .. +31 of the K = 8 rows of
//     tile g div (W/32); lane l reads one mode of each row:
//         mode = tile*K*W + k*W + 32*(g mod W/32) + l,
//     so the loads are coalesced, and since W and the tile base are
//     multiples of T_out, every mode of a thread folds onto the same
//     track, (32*(g mod W/32) + l) mod T_out: the per-sample partial of a
//     thread belongs to one track and needs no shuffle. At T_out dividing
//     32 (the main path), W = 32 and this is lane l owning modes
//     warp_base + 32*k + l, folding onto track l mod T_out. One fold loop
//     serves every T_out: it reads the lanes of track t from t minus the
//     warp's shift, which is 0 when T_out divides 32.
//   * No float atomics: the warps of a block are summed in a fixed order
//     through shared memory into one (S, T_out) partial per block, and a
//     second kernel sums the partials in block order. The result is
//     deterministic from run to run.
//
// Rounding: nvcc contracts re*c - im*s into an FMA by default, which
// rounds differently from the golden's separate f32 multiplies. The
// difference stays far inside the bank's 1e-4 relative-to-peak tolerance
// (models/modal.py), so contraction is left on for the rotation. The
// resonator's golden (modal_reference_gs) replays the exact f32 shear
// sequence, and a contracted shear would drift from it over a block, so
// the resonator rounds each multiply and add on its own (__fmul_rn,
// __fsub_rn, __fadd_rn): per mode it gives the golden's bits, and only
// the order of the fold's sums differs.
//
// Left for later tuning: modes per thread, block size against the 132
// SMs, and a persistent grid that would shrink the partials.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kModesPerThread = 8;
constexpr int kChunk = 32;  // samples per shared-memory round

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// Row width W = lcm(32, T_out), in modes.
int row_width(int t_out) { return 32 / gcd(32, t_out) * t_out; }

// Warps in the grid: tiles of kModesPerThread rows, W / 32 warps a tile.
long long num_warps(int m, int t_out) {
    const long long w = row_width(t_out);
    const long long tiles = (m + kModesPerThread * w - 1) / (kModesPerThread * w);
    return tiles * (w / 32);
}

// kRes: the resonator (a = eps, b unused, s0 = y, s1 = q); otherwise the
// rotation (a = cos, b = sin, s0 = re, s1 = im, amp optional).
template <bool kRes>
__global__ void __launch_bounds__(kThreads)
modal_bank_partials(const float* __restrict__ a_in,
                    const float* __restrict__ b_in,
                    const float* __restrict__ amp,
                    const float* __restrict__ s0_in,
                    const float* __restrict__ s1_in,
                    float* __restrict__ s0_out,
                    float* __restrict__ s1_out,
                    float* __restrict__ partials,
                    int m, int s, int t_out, int row_w) {
    __shared__ float lane_sums[kWarps][kChunk][32];
    __shared__ int warp_shift[kWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int cols = row_w / 32;
    const long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
    const int col = static_cast<int>(g % cols);
    const long long base = (g / cols) * kModesPerThread * row_w + 32LL * col;
    // Lane l of this warp folds onto track (warp_shift + l) mod T_out.
    if (lane == 0) warp_shift[warp] = (32 * col) % t_out;

    // Modes past the ragged edge hold a zero state under a unit rotation
    // (or a zero shear): they add nothing and are never stored.
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
            if (!kRes && amp != nullptr) {  // fold amp into the phasor (linear)
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
        __syncthreads();
        // Entry (j, t): warps in order, then the lanes of each warp that
        // fold onto t, in order.
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
        __syncthreads();
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

template <bool kRes>
int launch(const float* a, const float* b, const float* amp,
           const float* s0_in, const float* s1_in, float* s0_out,
           float* s1_out, float* partials, float* out, int m, int s,
           int t_out, int track_major, void* stream) {
    if (m <= 0 || s <= 0 || t_out <= 0 || m % t_out != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int row_w = row_width(t_out);
    const int blocks = static_cast<int>((num_warps(m, t_out) + kWarps - 1) / kWarps);
    modal_bank_partials<kRes><<<blocks, kThreads, 0, st>>>(
        a, b, amp, s0_in, s1_in, s0_out, s1_out, partials, m, s, t_out, row_w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int total = s * t_out;
    const int threads = 256;
    modal_bank_reduce<<<(total + threads - 1) / threads, threads, 0, st>>>(
        partials, out, blocks, s, t_out, track_major);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of (S, T_out) partials the wrapper allocates for m modes folded
// onto t_out tracks.
int modal_bank_num_blocks(int m, int t_out) {
    return static_cast<int>((num_warps(m, t_out) + kWarps - 1) / kWarps);
}

// Rotation form. amp may be null (states already amp-prefolded); re_out
// and im_out may both be null (states not wanted). No output may alias an
// input (the pointers are __restrict__). m must be a multiple of t_out.
// Returns cudaGetLastError() after the launches (0 on success).
int modal_bank_launch(const float* cos_w, const float* sin_w,
                      const float* amp, const float* re_in,
                      const float* im_in, float* re_out, float* im_out,
                      float* partials, float* out,
                      int m, int s, int t_out, int track_major,
                      void* stream) {
    return launch<false>(cos_w, sin_w, amp, re_in, im_in, re_out, im_out,
                         partials, out, m, s, t_out, track_major, stream);
}

// Resonator form on (eps, y, q); y_out and q_out may both be null.
int modal_res_launch(const float* eps, const float* y_in, const float* q_in,
                     float* y_out, float* q_out, float* partials, float* out,
                     int m, int s, int t_out, int track_major, void* stream) {
    return launch<true>(eps, nullptr, nullptr, y_in, q_in, y_out, q_out,
                        partials, out, m, s, t_out, track_major, stream);
}

}  // extern "C"
