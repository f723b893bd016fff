// Digital-waveguide strings for Hopper (sm_90a), bound through a plain C
// interface (gpuaudiobench_tpu_torch/utils/build.py loads it with ctypes).
//
// Replaces gpuaudiobench_tpu/ops/dwg_pallas.py:_dwg_kernel (reached through
// dwg_block_pallas), with the contract of ops/dwg.py:dwg_block. Waveguide g
// has forward and backward rails fwd[g, :], bwd[g, :] of length L_g within
// a row pitch Lmax. For each sample n of the block (writePos 0):
//     cur = n % L ; bpos = (cur + L/2) % L
//     f = fwd[g, cur] * damp ; b = bwd[g, bpos] * damp
//     if cur == in_tap:  f += x[n] * gain ; b += x[n] * gain
//     fwd[g, cur] = b * refl ; bwd[g, bpos] = f * refl
//     if cur == out_tap: out[n] += (f + b) * 0.5
// The TPU had no scatter, so its kernel read and wrote the rails through
// one-hot lane masks over whole rows (and the JAX package's production path
// is a separate arc-window form, ops/dwg_arc.py). Here each thread owns one
// waveguide and indexes its rails directly; one kernel serves DWG1DNaive,
// DWG1DAccel and the stream.
//
// What bounds it: bytes. A waveguide touches min(L, S) cell pairs per
// block, each read and written once: at 32,768 waveguides x 512 samples
// with lengths 100-2,000, ~16.4 M positions x 16 bytes = 263 MB, 0.078 ms
// at 3.35 TB/s, against 10 FLOP per waveguide and sample (0.0025 ms of
// FP32). When L < S the same cells come round again within the block, so
// each waveguide is a serial recurrence over n, and the design is simple:
//   * One thread per waveguide, walking cur and bpos with a wrap instead
//     of a modulo. A warp's 32 loads touch 32 rows, so they do not
//     coalesce; a thread's next 7 samples fall in the same 32-byte sector,
//     which L1 usually still holds.
//   * The rails are updated in place; a caller that needs its starting
//     rails clones them first.
//   * Each product and sum is rounded on its own (__fmul_rn, __fadd_rn):
//     nvcc would contract f * damp + x * gain into an FMA, and the golden
//     and the plain twin round every step.
//   * The mono output is summed without atomics, in a fixed order: a warp
//     sums its 32 waveguides by a butterfly of shuffles (skipped when no
//     lane is at its output tap), a block sums its warps in order into a
//     partial (S, n_blocks), and a second kernel sums the partials in
//     block order. The sum is the same bits run to run.
//   * The block's input samples are staged in shared memory, 1,024 at a
//     time.
// Rows with L outside [1, Lmax] are left untouched (the wrapper's caller
// checks lengths on the host).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;  // input samples staged per pass

__global__ void __launch_bounds__(kThreads)
dwg_block_kernel(const float* __restrict__ x,
                 float* __restrict__ fwd,
                 float* __restrict__ bwd,
                 const int* __restrict__ lengths,
                 const int* __restrict__ in_taps,
                 const int* __restrict__ out_taps,
                 const float* __restrict__ gains,
                 const float* __restrict__ refls,
                 const float* __restrict__ damps,
                 float* __restrict__ partials,
                 int guides, int lmax, int s) {
    __shared__ float xs[kChunk];
    __shared__ float warp_sums[kWarps][kChunk];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = blockIdx.x * kThreads + tid;

    int len = 1, itap = -1, otap = -1;
    float gain = 0.f, refl = 0.f, damp = 0.f;
    bool active = false;
    if (g < guides) {
        len = lengths[g];
        active = len >= 1 && len <= lmax;
        itap = in_taps[g];
        otap = out_taps[g];
        gain = gains[g];
        refl = refls[g];
        damp = damps[g];
    }
    if (!active) len = 1;
    float* f_row = fwd + static_cast<long long>(active ? g : 0) * lmax;
    float* b_row = bwd + static_cast<long long>(active ? g : 0) * lmax;
    int cur = 0;
    int bpos = (len / 2) % len;

    for (int n0 = 0; n0 < s; n0 += kChunk) {
        const int cn = min(kChunk, s - n0);
        __syncthreads();  // the previous pass is done with xs and warp_sums
        for (int j = tid; j < cn; j += kThreads) xs[j] = x[n0 + j];
        __syncthreads();
        for (int j = 0; j < cn; ++j) {
            float contrib = 0.f;
            bool hit = false;
            if (active) {
                float f = __fmul_rn(f_row[cur], damp);
                float b = __fmul_rn(b_row[bpos], damp);
                if (cur == itap) {
                    const float inj = __fmul_rn(xs[j], gain);
                    f = __fadd_rn(f, inj);
                    b = __fadd_rn(b, inj);
                }
                f_row[cur] = __fmul_rn(b, refl);
                b_row[bpos] = __fmul_rn(f, refl);
                if (cur == otap) {
                    hit = true;
                    contrib = __fmul_rn(__fadd_rn(f, b), 0.5f);
                }
                if (++cur == len) cur = 0;
                if (++bpos == len) bpos = 0;
            }
            if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
                for (int off = 16; off > 0; off >>= 1) {
                    contrib += __shfl_xor_sync(0xffffffffu, contrib, off);
                }
            }
            if (lane == 0) warp_sums[warp][j] = contrib;
        }
        __syncthreads();
        for (int j = tid; j < cn; j += kThreads) {
            float acc = warp_sums[0][j];
#pragma unroll
            for (int w = 1; w < kWarps; ++w) acc += warp_sums[w][j];
            partials[static_cast<long long>(n0 + j) * gridDim.x + blockIdx.x] =
                acc;
        }
    }
}

// out[n] = sum over blocks b, in order, of partials[n, b].
__global__ void dwg_sum_kernel(const float* __restrict__ partials,
                               float* __restrict__ out, int n_blocks, int s) {
    const int n = blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= s) return;
    const float* row = partials + static_cast<long long>(n) * n_blocks;
    float acc = 0.f;
    for (int b = 0; b < n_blocks; ++b) acc += row[b];
    out[n] = acc;
}

}  // namespace

extern "C" {

// Blocks of the update kernel for `guides` waveguides: the partials
// buffer is (s, dwg_blocks(guides)) float32.
int dwg_blocks(int guides) { return (guides + kThreads - 1) / kThreads; }

// x (s,), fwd and bwd (guides, lmax) updated in place, lengths, in_taps,
// out_taps (guides,) int32, gains, refls, damps (guides,) float32,
// partials (s, dwg_blocks(guides)) scratch, out (s,); all contiguous.
// Returns cudaGetLastError() after the two launches (0 on success).
int dwg_block_launch(const float* x, float* fwd, float* bwd,
                     const int* lengths, const int* in_taps,
                     const int* out_taps, const float* gains,
                     const float* refls, const float* damps,
                     float* partials, float* out,
                     int guides, int lmax, int s, void* stream) {
    if (guides <= 0 || lmax <= 0 || s <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = dwg_blocks(guides);
    dwg_block_kernel<<<blocks, kThreads, 0, st>>>(
        x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
        partials, guides, lmax, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dwg_sum_kernel<<<(s + 255) / 256, 256, 0, st>>>(partials, out, blocks, s);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
