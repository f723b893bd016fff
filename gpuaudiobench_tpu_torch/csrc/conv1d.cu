// Direct per-track FIR for Hopper (sm_90a), bound through a plain C
// interface (gpuaudiobench_tpu_torch/utils/build.py loads it with ctypes).
//
// Replaces gpuaudiobench_tpu/ops/conv_pallas.py:_conv_kernel (reached
// through conv1d_direct_pallas from ops/conv.py:conv1d_direct). With x
// (T, S) track-major and one IR per track, ir (T, L):
//     out[t, s] = sum over l in [0, L) of ir[t, l] * xw(t, s - l)
// summed in tap order, where the window xw reads before sample 0 of a
// track according to the edge mode:
//   * clamp: zero (the window stays inside the track);
//   * bleed: the flat track-major buffer, xw(t, n) = x_flat[t*S + n], zero
//     below flat index 0. When L - 1 > S that reaches back across several
//     earlier tracks, as the reference's golden and the CUDA reference's
//     flat indexing do (the JAX package pads with the previous track only).
// The TPU wrapper built an edge-padded (T, S + L - 1) copy and transposed
// it to put tracks on the lanes; this kernel reads the track-major input
// and builds its window itself, with no copy in device memory.
//
// What bounds it: operations. At 19,456 tracks x 512 samples x 1,024 taps
// one block is 2*T*S*L = 20.4 GFLOP, 0.304 ms at the H100's 67 TFLOP/s of
// FP32, against 0.048 ms for its 160 MB of bytes (x and the IRs read, out
// written). The design aims at FMA issue:
//   * One block of one warp per (track, 512-output tile). The tile's
//     window and a chunk of up to 1,024 taps are staged in shared memory
//     (10.3 KiB), read from device memory once per block with consecutive
//     threads on consecutive samples; longer IRs loop over tap chunks with
//     the sums held in registers.
//   * Each thread owns 16 consecutive outputs and slides a register window
//     along the taps: per tap it loads one new window value and issues 16
//     FMAs; the taps come 4 at a time in broadcast 16-byte loads.
//   * The window is stored by residue: sample j of the window sits in row
//     j mod 16, column j / 16 (rows padded by one word). A thread's window
//     loads then sit on consecutive columns across the warp (no bank
//     conflicts), and the 16 loads of a 16-tap step are fixed offsets
//     from one pointer that moves back one column per step, so the loop
//     spends no integer instructions on addresses. (The first version,
//     64 threads x 8 outputs over a skewed linear window, ran at 0.615 ms
//     against this layout's 0.434 ms at the shape above on an H100 80GB
//     HBM3 at its 700 W limit; PERF.md.)
//   * Ragged shapes are masked here: outputs past S are not stored, taps
//     past L are zero in shared memory, and a chunk runs its taps rounded
//     up to 16.
// A tensor-core Toeplitz form is left for later.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kOuts = 16;                     // outputs per thread
constexpr int kTile = kThreads * kOuts;       // outputs per block
constexpr int kTaps = 1024;                   // taps per shared-memory chunk
constexpr int kWin = kTile + kTaps;           // staged window length
constexpr int kPitch = kWin / kOuts + 1;      // row r holds j = kOuts*q + r

// Block b handles track b / n_tiles, outputs (b mod n_tiles) * kTile ...
__global__ void __launch_bounds__(kThreads)
conv1d_direct_kernel(const float* __restrict__ x,
                     const float* __restrict__ ir,
                     float* __restrict__ out,
                     int s, int l, int n_tiles, int bleed) {
    __shared__ float win[kOuts * kPitch];
    __shared__ __align__(16) float taps[kTaps];
    const long long track = blockIdx.x / n_tiles;
    const int s_tile = static_cast<int>(blockIdx.x % n_tiles) * kTile;
    const long long flat0 = track * s;  // flat index of x[track, 0]
    const float* ir_t = ir + track * l;
    const int tid = threadIdx.x;

    float acc[kOuts];
#pragma unroll
    for (int r = 0; r < kOuts; ++r) acc[r] = 0.f;

    for (int l0 = 0; l0 < l; l0 += kTaps) {
        const int lt = min(kTaps, l - l0);
        const int ltr = (lt + kOuts - 1) / kOuts * kOuts;
        for (int k = tid; k < ltr; k += kThreads) {
            taps[k] = k < lt ? ir_t[l0 + k] : 0.f;
        }
        // Window sample j = xw(track, s_tile - l0 - kTaps + j): output i of
        // the tile at tap l0 + k reads j = i - k + kTaps.
        const long long n0 = static_cast<long long>(s_tile) - l0 - kTaps;
        for (int j = tid; j < kWin; j += kThreads) {
            const long long n = n0 + j;
            float v = 0.f;
            if (n >= 0) {
                if (n < s) v = x[flat0 + n];
            } else if (bleed && flat0 + n >= 0) {
                v = x[flat0 + n];
            }
            win[(j % kOuts) * kPitch + j / kOuts] = v;
        }
        __syncthreads();

        // Thread tid owns outputs kOuts*tid + r. Before the step at tap k
        // (a multiple of kOuts), w[r] is window sample
        // kOuts*(tid + (kTaps - k)/kOuts) + r: row r of that column. A
        // step's new samples are rows kOuts-1 .. 0 of the column to its
        // left, and the register window turns over once per step, so the
        // shifts below are renamings, not moves.
        float w[kOuts];
        const float* col = win + tid + kTaps / kOuts;
#pragma unroll
        for (int r = 0; r < kOuts; ++r) w[r] = col[r * kPitch];
        for (int k = 0; k < ltr; k += kOuts) {
            float hk[kOuts];
#pragma unroll
            for (int q = 0; q < kOuts; q += 4) {
                const float4 h = *reinterpret_cast<const float4*>(&taps[k + q]);
                hk[q] = h.x;
                hk[q + 1] = h.y;
                hk[q + 2] = h.z;
                hk[q + 3] = h.w;
            }
            col -= 1;  // never below column tid: k <= kTaps - kOuts
#pragma unroll
            for (int u = 0; u < kOuts; ++u) {
#pragma unroll
                for (int r = 0; r < kOuts; ++r) acc[r] = fmaf(hk[u], w[r], acc[r]);
#pragma unroll
                for (int r = kOuts - 1; r > 0; --r) w[r] = w[r - 1];
                w[0] = col[(kOuts - 1 - u) * kPitch];
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < kOuts; ++r) {
        const int n = s_tile + kOuts * tid + r;
        if (n < s) out[flat0 + n] = acc[r];
    }
}

}  // namespace

extern "C" {

// x (tracks, s), ir (tracks, l), out (tracks, s), all float32 and
// contiguous; bleed 0 = clamp, 1 = bleed. out may not alias x or ir.
// Returns cudaGetLastError() after the launch (0 on success).
int conv1d_direct_launch(const float* x, const float* ir, float* out,
                         int tracks, int s, int l, int bleed, void* stream) {
    if (tracks <= 0 || s <= 0 || l <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int n_tiles = (s + kTile - 1) / kTile;
    const long long blocks = static_cast<long long>(tracks) * n_tiles;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    conv1d_direct_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        x, ir, out, s, l, n_tiles, bleed != 0 ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
