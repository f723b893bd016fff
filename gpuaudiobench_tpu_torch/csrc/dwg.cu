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
// is a separate arc-window form, ops/dwg_arc.py). One kernel here serves
// DWG1DNaive, DWG1DAccel and the stream.
//
// The structure: every block restarts at writePos 0, so fwd cell p is
// touched only at the samples n = p, p + L, ... < S, and so is its partner
// bwd cell (p + L/2) % L. Each such cell pair, p < min(L, S), is closed:
// no other pair reads it, and its block is a chain of ceil((S - p) / L)
// steps on two values (one step for L >= S, at most ceil(S / min L)).
//
// What bounds it: bytes. Each touched pair is read and written once: at
// 32,768 waveguides x 512 samples with lengths 100-2,000, ~15.3 M pairs x
// 16 bytes = 245 MB, 0.073 ms at 3.35 TB/s, against 10 FLOP a waveguide
// and sample (0.0025 ms of FP32). So the design puts many independent,
// coalesced loads in flight:
//   * Update blocks: a warp owns 32 * kPairs (256) consecutive cells of
//     one row (a "segment"), lane l holding pairs p = base + l + 32 j. A
//     warp's fwd loads are one 128-byte line, its bwd loads the window
//     [L/2, L/2 + S) mod L, contiguous but for the wrap. A thread loads
//     all its pairs first, walks their chains in registers (the chain of
//     pair j is the chain of pair 0 shifted by 32 j samples) and stores
//     each pair once: no barrier, no atomics. Threads past min(L, S) idle
//     (so a row narrower than a segment wastes lanes, not correctness).
//   * The output-tap pair of each row is left to the mono blocks, which
//     own it outright: only it contributes to the output, at n = out_tap
//     + k L < S. The first ceil(G / 128) blocks of the same launch each
//     take 128 waveguides (the old kernel's block): lane i of warp w holds
//     row 128 b + 32 w + i's pair; the warp steps from sample to sample
//     where one of its lanes contributes (__reduce_min_sync over each
//     lane's next sample), sums the lanes there by the xor butterfly and
//     writes the warp's sum into shared memory (zero elsewhere); the
//     group's four warps are then added in order into group_sums (group,
//     sample). These blocks touch no cell an update block touches, so
//     both run in one launch.
//   * A fold kernel adds the groups of each sample in order from 0.f: a
//     block stages 256 groups x 32 samples in shared memory (loads
//     coalesced along the samples) and one warp folds them.
//   The mono output is therefore summed in the present kernel's order
//   (butterfly over 32 waveguides, 4 warps in order, 128-waveguide groups
//   in order from 0.f): the same bits as before, run to run. Zero lanes
//   and zero samples change no sum.
//   * Each product and sum is rounded on its own (__fmul_rn, __fadd_rn):
//     nvcc would contract f * damp + x * gain into an FMA, and the golden
//     and the plain twin round every step. The rails are the twin's bits.
//   * The rails are updated in place; a caller that needs its starting
//     rails clones them first.
// The launch geometry (segments a row, groups, blocks) comes from
// ops/dwg.py:dwg_schedule; dwg_block_launch refuses one that does not
// cover the shape. Rows with L outside [1, Lmax] are left
// untouched (the wrapper's caller checks lengths on the host).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // a block; a mono group's waveguides
constexpr int kPairs = 8;              // cell pairs a thread
constexpr int kChunk = 512;            // samples of a group's sums at once
constexpr int kFoldCols = 32;          // samples a fold block
constexpr int kFoldRows = 8;           // warps a fold block
constexpr int kFoldTile = 256;         // groups staged a pass

struct Row {
    int len, itap, otap;
    float gain, refl, damp;
};

__device__ __forceinline__ Row load_row(const int* __restrict__ lengths,
                                        const int* __restrict__ in_taps,
                                        const int* __restrict__ out_taps,
                                        const float* __restrict__ gains,
                                        const float* __restrict__ refls,
                                        const float* __restrict__ damps,
                                        long long g) {
    return Row{lengths[g], in_taps[g], out_taps[g], gains[g], refls[g],
               damps[g]};
}

// One step of a cell pair (fv, bv); returns its mono contribution.
__device__ __forceinline__ float pair_step(float& fv, float& bv, const Row& r,
                                           bool inject, float xn) {
    float f = __fmul_rn(fv, r.damp);
    float b = __fmul_rn(bv, r.damp);
    if (inject) {
        const float inj = __fmul_rn(xn, r.gain);
        f = __fadd_rn(f, inj);
        b = __fadd_rn(b, inj);
    }
    fv = __fmul_rn(b, r.refl);
    bv = __fmul_rn(f, r.refl);
    return __fmul_rn(__fadd_rn(f, b), 0.5f);
}

// A warp's segment of one row: pairs p = base + 32 j, j < Pairs (base =
// the segment's start + lane), all but the out-tap pair.
template <int Pairs>
__device__ __forceinline__ void update_segment(const float* __restrict__ x,
                                               float* __restrict__ f_row,
                                               float* __restrict__ b_row,
                                               const Row& r, int s, int base) {
    const int lim = min(r.len, s);
    const int half = r.len >> 1;
    float fv[Pairs], bv[Pairs];
    int bp[Pairs];
    bool on[Pairs];
#pragma unroll
    for (int j = 0; j < Pairs; ++j) {
        const int p = base + 32 * j;
        on[j] = p < lim && p != r.otap;
        bp[j] = p + half < r.len ? p + half : p + half - r.len;
        fv[j] = on[j] ? f_row[p] : 0.f;
        bv[j] = on[j] ? b_row[bp[j]] : 0.f;
    }
    // n walks pair 0's samples; pair j is at n + 32 j, and ends no later.
    for (int n = base; n < s; n += r.len) {
#pragma unroll
        for (int j = 0; j < Pairs; ++j) {
            const int p = base + 32 * j;
            if (on[j] && n + 32 * j < s) {
                const bool inj = p == r.itap;
                pair_step(fv[j], bv[j], r, inj, inj ? x[n + 32 * j] : 0.f);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < Pairs; ++j) {
        if (on[j]) {
            f_row[base + 32 * j] = fv[j];
            b_row[bp[j]] = bv[j];
        }
    }
}

// A mono group: 128 waveguides' out-tap pairs walked and stepped, their
// contributions summed in the old kernel's order into
// sums_out[group * gstride + n * nstride].
__device__ __forceinline__ void mono_group(
    const float* __restrict__ x, float* __restrict__ fwd,
    float* __restrict__ bwd, const int* __restrict__ lengths,
    const int* __restrict__ in_taps, const int* __restrict__ out_taps,
    const float* __restrict__ gains, const float* __restrict__ refls,
    const float* __restrict__ damps, float* __restrict__ sums_out,
    long long gstride, long long nstride, int guides, int lmax, int s,
    int group) {
    __shared__ float sums[kWarps][kChunk];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long g = static_cast<long long>(group) * kThreads + tid;
    Row r{1, -1, -1, 0.f, 0.f, 0.f};
    bool valid = false;
    if (g < guides) {
        r = load_row(lengths, in_taps, out_taps, gains, refls, damps, g);
        valid = r.len >= 1 && r.len <= lmax && r.otap >= 0 &&
                r.otap < min(r.len, s);
    }
    float* f_row = fwd + (valid ? g : 0) * lmax;
    float* b_row = bwd + (valid ? g : 0) * lmax;
    int bp = 0;
    float fv = 0.f, bv = 0.f;
    int n = INT_MAX;  // this lane's next sample
    if (valid) {
        const int half = r.len >> 1;
        bp = r.otap + half < r.len ? r.otap + half : r.otap + half - r.len;
        fv = f_row[r.otap];
        bv = b_row[bp];
        n = r.otap;
    }
    const bool inj = valid && r.otap == r.itap;
    for (int n0 = 0; n0 < s; n0 += kChunk) {
        const int cn = min(kChunk, s - n0);
        for (int j = lane; j < cn; j += 32) sums[warp][j] = 0.f;
        __syncwarp();
        for (int m = __reduce_min_sync(0xffffffffu, n); m < n0 + cn;
             m = __reduce_min_sync(0xffffffffu, n)) {
            float c = 0.f;
            if (n == m) {
                c = pair_step(fv, bv, r, inj, inj ? x[n] : 0.f);
                n = s - n > r.len ? n + r.len : INT_MAX;
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                c += __shfl_xor_sync(0xffffffffu, c, off);
            }
            if (lane == 0) sums[warp][m - n0] = c;
        }
        __syncthreads();
        for (int j = tid; j < cn; j += kThreads) {
            float acc = sums[0][j];
#pragma unroll
            for (int w = 1; w < kWarps; ++w) acc += sums[w][j];
            sums_out[group * gstride + (n0 + j) * nstride] = acc;
        }
        __syncthreads();  // the next chunk zeroes sums
    }
    if (valid) {
        f_row[r.otap] = fv;
        b_row[bp] = bv;
    }
}

// Blocks [0, groups): mono groups; then update blocks, warp task t =
// (block - groups) * kWarps + warp on row t / segs, segment t % segs.
// The port launches it at kPairs pairs a thread.
template <int Pairs>
__global__ void __launch_bounds__(kThreads)
dwg_block_kernel(const float* __restrict__ x, float* __restrict__ fwd,
                 float* __restrict__ bwd, const int* __restrict__ lengths,
                 const int* __restrict__ in_taps,
                 const int* __restrict__ out_taps,
                 const float* __restrict__ gains,
                 const float* __restrict__ refls,
                 const float* __restrict__ damps,
                 float* __restrict__ group_sums, int guides, int lmax, int s,
                 int groups, int segs) {
    if (static_cast<int>(blockIdx.x) < groups) {
        mono_group(x, fwd, bwd, lengths, in_taps, out_taps, gains, refls,
                   damps, group_sums, s, 1, guides, lmax, s, blockIdx.x);
        return;
    }
    const long long task =
        (static_cast<long long>(blockIdx.x) - groups) * kWarps +
        (threadIdx.x >> 5);
    const long long row = task / segs;
    const int start = static_cast<int>(task - row * segs) * 32 * Pairs;
    if (row >= guides) return;
    const Row r = load_row(lengths, in_taps, out_taps, gains, refls, damps,
                           row);
    if (r.len < 1 || r.len > lmax || start >= min(r.len, s)) return;
    update_segment<Pairs>(x, fwd + row * lmax, bwd + row * lmax, r, s,
                           start + (threadIdx.x & 31));
}

// out[n] = the group sums of sample n added in group order from 0.f.
__global__ void __launch_bounds__(kFoldCols * kFoldRows)
dwg_fold_kernel(const float* __restrict__ group_sums, float* __restrict__ out,
                int groups, int s) {
    __shared__ float tile[kFoldTile][kFoldCols];
    const int col = threadIdx.x;
    const int row = threadIdx.y;
    const int n = blockIdx.x * kFoldCols + col;
    float acc = 0.f;
    for (int k0 = 0; k0 < groups; k0 += kFoldTile) {
        const int kn = min(kFoldTile, groups - k0);
        for (int k = row; k < kn; k += kFoldRows) {
            tile[k][col] = n < s ? group_sums[static_cast<long long>(k0 + k) *
                                              s + n]
                                 : 0.f;
        }
        __syncthreads();
        if (row == 0) {
#pragma unroll 8
            for (int k = 0; k < kn; ++k) acc = __fadd_rn(acc, tile[k][col]);
        }
        __syncthreads();
    }
    if (row == 0 && n < s) out[n] = acc;
}

}  // namespace

extern "C" {

// x (s,), fwd and bwd (guides, lmax) updated in place, lengths, in_taps,
// out_taps (guides,) int32, gains, refls, damps (guides,) float32,
// group_sums (groups, s) scratch, out (s,); all contiguous. The schedule
// (ops/dwg.py:dwg_schedule): segments of 32 * kPairs cells a row, groups
// = ceil(guides / 128), update_blocks = ceil(guides * segs / 4). Returns
// cudaErrorInvalidValue for a schedule that does not cover the shape,
// else cudaGetLastError() after the two launches.
int dwg_block_launch(const float* x, float* fwd, float* bwd,
                     const int* lengths, const int* in_taps,
                     const int* out_taps, const float* gains,
                     const float* refls, const float* damps,
                     float* group_sums, float* out, int guides, int lmax,
                     int s, int segs, int groups, int update_blocks,
                     void* stream) {
    const long long width = lmax < s ? lmax : s;
    const long long seg_cells = 32LL * kPairs;
    const long long want_blocks =
        (static_cast<long long>(guides) * segs + kWarps - 1) / kWarps;
    if (guides <= 0 || lmax <= 0 || s <= 0 || segs < 1 ||
        segs * seg_cells < width || (segs - 1) * seg_cells >= width ||
        groups != (guides + kThreads - 1) / kThreads ||
        update_blocks != want_blocks ||
        static_cast<long long>(groups) + update_blocks > INT_MAX) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    dwg_block_kernel<kPairs><<<groups + update_blocks, kThreads, 0, st>>>(
        x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
        group_sums, guides, lmax, s, groups, segs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dwg_fold_kernel<<<(s + kFoldCols - 1) / kFoldCols,
                      dim3(kFoldCols, kFoldRows), 0, st>>>(group_sums, out,
                                                           groups, s);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
