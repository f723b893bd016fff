// Measurements behind PERF.md's account of the DWG block kernels
// (csrc/dwg.cu): the kernel pair as it shipped before its redesign
// (verbatim, in namespace old_form), the redesigned pair (included) and
// its variants, built into one library with a plain C interface. run.py
// (beside this file) builds it with nvcc and drives it on one CUDA
// device. Nothing of the port loads this file.
//
// * old_dwg_block_launch: one thread a waveguide walking the block's
//   samples in series, partials (S, blocks) folded by dwg_sum_kernel.
// * dwg_block_launch (csrc/dwg.cu, included): the shipped pair, at 8
//   pairs a thread; pairs_launch the same pair at 1, 2, 4 or 16.
// * two_kernel_launch: the block kernel at 8 pairs, then another fold:
//   narrow_fold_kernel (a block of 256 threads stages 256 groups x 8
//   samples, one 32-byte sector a group, and 8 threads fold them) in an
//   ordinary launch, or as a programmatic dependent launch after a block
//   kernel whose blocks allow it at their start (pdl_block_kernel); or
//   the group sums in the old (sample, group) layout, folded by the old
//   sum kernel.
// * last_block_launch: the second version, no fold kernel: the last mono
//   block to finish (an atomicInc counter) folds every sample.
// * update_only_launch / mono_only_launch / fold_only_launch: the shipped
//   block kernel's update blocks alone (every pair but the out-tap
//   pairs), its mono blocks alone, and each fold kernel alone.
// * stage_occupancy: blocks an SM of each kernel (the occupancy API).

#include "../../gpuaudiobench_tpu_torch/csrc/dwg.cu"

namespace old_form {

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

}  // namespace old_form

namespace {

constexpr int kNarrowCols = 8;       // samples a narrow_fold_kernel block
constexpr int kNarrowThreads = 256;

// out[n] = the group sums of sample n added in group order from 0.f; when
// launched as a programmatic dependent launch, after the block kernel's
// grid completes.
__global__ void __launch_bounds__(kNarrowThreads)
narrow_fold_kernel(const float* __restrict__ group_sums,
                   float* __restrict__ out, int groups, int s) {
    constexpr int kRows = kNarrowThreads / kNarrowCols;
    __shared__ float tile[kFoldTile][kNarrowCols];
    const int col = threadIdx.x % kNarrowCols;
    const int row = threadIdx.x / kNarrowCols;
    const int n = blockIdx.x * kNarrowCols + col;
    asm volatile("griddepcontrol.wait;" ::: "memory");
    float acc = 0.f;
    for (int k0 = 0; k0 < groups; k0 += kFoldTile) {
        const int kn = min(kFoldTile, groups - k0);
#pragma unroll
        for (int i = 0; i < kFoldTile / kRows; ++i) {
            const int k = row + i * kRows;
            if (k < kn) {
                tile[k][col] =
                    n < s ? group_sums[static_cast<long long>(k0 + k) * s + n]
                          : 0.f;
            }
        }
        __syncthreads();
        if (threadIdx.x < kNarrowCols) {
#pragma unroll 16
            for (int k = 0; k < kn; ++k) acc = __fadd_rn(acc, tile[k][col]);
        }
        __syncthreads();
    }
    if (threadIdx.x < kNarrowCols && n < s) out[n] = acc;
}

cudaError_t launch_narrow_fold(const float* group_sums, float* out,
                               int groups, int s, bool dependent,
                               cudaStream_t st) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((s + kNarrowCols - 1) / kNarrowCols);
    cfg.blockDim = dim3(kNarrowThreads);
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = dependent ? 1 : 0;
    return cudaLaunchKernelEx(&cfg, narrow_fold_kernel, group_sums, out,
                              groups, s);
}

// The block kernel's update path for block b >= groups.
template <int kPairs>
__device__ __forceinline__ void update_block(
    const float* __restrict__ x, float* __restrict__ fwd,
    float* __restrict__ bwd, const int* __restrict__ lengths,
    const int* __restrict__ in_taps, const int* __restrict__ out_taps,
    const float* __restrict__ gains, const float* __restrict__ refls,
    const float* __restrict__ damps, int guides, int lmax, int s, int groups,
    int segs) {
    const long long task =
        (static_cast<long long>(blockIdx.x) - groups) * kWarps +
        (threadIdx.x >> 5);
    const long long row = task / segs;
    const int start = static_cast<int>(task - row * segs) * 32 * kPairs;
    if (row >= guides) return;
    const Row r = load_row(lengths, in_taps, out_taps, gains, refls, damps,
                           row);
    if (r.len < 1 || r.len > lmax || start >= min(r.len, s)) return;
    update_segment<kPairs>(x, fwd + row * lmax, bwd + row * lmax, r, s,
                           start + (threadIdx.x & 31));
}

// The group sums in the old layout (sample, group).
__global__ void __launch_bounds__(kThreads)
old_layout_kernel(const float* __restrict__ x, float* __restrict__ fwd,
                  float* __restrict__ bwd, const int* __restrict__ lengths,
                  const int* __restrict__ in_taps,
                  const int* __restrict__ out_taps,
                  const float* __restrict__ gains,
                  const float* __restrict__ refls,
                  const float* __restrict__ damps, float* __restrict__ sums,
                  int guides, int lmax, int s, int groups, int segs) {
    if (static_cast<int>(blockIdx.x) < groups) {
        mono_group(x, fwd, bwd, lengths, in_taps, out_taps, gains, refls,
                   damps, sums, 1, groups, guides, lmax, s, blockIdx.x);
        return;
    }
    update_block<8>(x, fwd, bwd, lengths, in_taps, out_taps, gains, refls,
                    damps, guides, lmax, s, groups, segs);
}

// The block kernel, each block allowing the dependent fold to launch.
__global__ void __launch_bounds__(kThreads)
pdl_block_kernel(const float* __restrict__ x, float* __restrict__ fwd,
                 float* __restrict__ bwd, const int* __restrict__ lengths,
                 const int* __restrict__ in_taps,
                 const int* __restrict__ out_taps,
                 const float* __restrict__ gains,
                 const float* __restrict__ refls,
                 const float* __restrict__ damps, float* __restrict__ sums,
                 int guides, int lmax, int s, int groups, int segs) {
    asm volatile("griddepcontrol.launch_dependents;");
    if (static_cast<int>(blockIdx.x) < groups) {
        mono_group(x, fwd, bwd, lengths, in_taps, out_taps, gains, refls,
                   damps, sums, s, 1, guides, lmax, s, blockIdx.x);
        return;
    }
    update_block<8>(x, fwd, bwd, lengths, in_taps, out_taps, gains, refls,
                    damps, guides, lmax, s, groups, segs);
}

// The second version: the last mono block to finish folds the groups (in
// order, through L2); *done is 0 at the launch and after it.
__global__ void __launch_bounds__(kThreads)
last_block_kernel(const float* __restrict__ x, float* __restrict__ fwd,
                  float* __restrict__ bwd, const int* __restrict__ lengths,
                  const int* __restrict__ in_taps,
                  const int* __restrict__ out_taps,
                  const float* __restrict__ gains,
                  const float* __restrict__ refls,
                  const float* __restrict__ damps,
                  float* __restrict__ group_sums, float* __restrict__ out,
                  unsigned int* __restrict__ done, int guides, int lmax,
                  int s, int groups, int segs) {
    if (static_cast<int>(blockIdx.x) < groups) {
        __shared__ bool last;
        mono_group(x, fwd, bwd, lengths, in_taps, out_taps, gains, refls,
                   damps, group_sums, s, 1, guides, lmax, s, blockIdx.x);
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) {
            const unsigned int top = static_cast<unsigned int>(groups - 1);
            last = atomicInc(done, top) == top;
        }
        __syncthreads();
        if (last) {
            __threadfence();
            for (int n = threadIdx.x; n < s; n += kThreads) {
                float acc = 0.f;
#pragma unroll 16
                for (int k = 0; k < groups; ++k) {
                    acc = __fadd_rn(acc, __ldcg(group_sums +
                                                static_cast<long long>(k) * s + n));
                }
                out[n] = acc;
            }
        }
        return;
    }
    update_block<8>(x, fwd, bwd, lengths, in_taps, out_taps, gains, refls,
                    damps, guides, lmax, s, groups, segs);
}

}  // namespace

extern "C" {

int old_dwg_blocks(int guides) {
    return (guides + old_form::kThreads - 1) / old_form::kThreads;
}

int old_dwg_block_launch(const float* x, float* fwd, float* bwd,
                         const int* lengths, const int* in_taps,
                         const int* out_taps, const float* gains,
                         const float* refls, const float* damps,
                         float* partials, float* out, int guides, int lmax,
                         int s, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = old_dwg_blocks(guides);
    old_form::dwg_block_kernel<<<blocks, old_form::kThreads, 0, st>>>(
        x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
        partials, guides, lmax, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    old_form::dwg_sum_kernel<<<(s + 255) / 256, 256, 0, st>>>(partials, out,
                                                              blocks, s);
    return static_cast<int>(cudaGetLastError());
}

// The shipped pair at `pairs` (1, 2, 4 or 16) pairs a thread, segs and
// update_blocks from the schedule's rule at that count.
int pairs_launch(const float* x, float* fwd, float* bwd, const int* lengths,
                 const int* in_taps, const int* out_taps, const float* gains,
                 const float* refls, const float* damps, float* group_sums,
                 float* out, int guides, int lmax, int s, int pairs, int segs,
                 int groups, int update_blocks, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = groups + update_blocks;
    switch (pairs) {
        case 1:
            dwg_block_kernel<1><<<blocks, kThreads, 0, st>>>(
                x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
                group_sums, guides, lmax, s, groups, segs);
            break;
        case 2:
            dwg_block_kernel<2><<<blocks, kThreads, 0, st>>>(
                x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
                group_sums, guides, lmax, s, groups, segs);
            break;
        case 4:
            dwg_block_kernel<4><<<blocks, kThreads, 0, st>>>(
                x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
                group_sums, guides, lmax, s, groups, segs);
            break;
        case 16:
            dwg_block_kernel<16><<<blocks, kThreads, 0, st>>>(
                x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
                group_sums, guides, lmax, s, groups, segs);
            break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dwg_fold_kernel<<<(s + kFoldCols - 1) / kFoldCols,
                      dim3(kFoldCols, kFoldRows), 0, st>>>(group_sums, out,
                                                           groups, s);
    return static_cast<int>(cudaGetLastError());
}

// fold 0: dwg_block_kernel<8>, then narrow_fold_kernel in an ordinary
// launch; 1: pdl_block_kernel, then narrow_fold_kernel as its programmatic
// dependent launch; 2: old_layout_kernel, then the old sum kernel over
// sums (s, groups).
int two_kernel_launch(const float* x, float* fwd, float* bwd,
                      const int* lengths, const int* in_taps,
                      const int* out_taps, const float* gains,
                      const float* refls, const float* damps, float* sums,
                      float* out, int guides, int lmax, int s, int segs,
                      int groups, int update_blocks, int fold, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = groups + update_blocks;
    if (fold == 2) {
        old_layout_kernel<<<blocks, kThreads, 0, st>>>(
            x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
            sums, guides, lmax, s, groups, segs);
    } else if (fold == 1) {
        pdl_block_kernel<<<blocks, kThreads, 0, st>>>(
            x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
            sums, guides, lmax, s, groups, segs);
    } else {
        dwg_block_kernel<8><<<blocks, kThreads, 0, st>>>(
            x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
            sums, guides, lmax, s, groups, segs);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fold == 2) {
        old_form::dwg_sum_kernel<<<(s + 255) / 256, 256, 0, st>>>(sums, out,
                                                                  groups, s);
        return static_cast<int>(cudaGetLastError());
    }
    return static_cast<int>(
        launch_narrow_fold(sums, out, groups, s, fold == 1, st));
}

int last_block_launch(const float* x, float* fwd, float* bwd,
                      const int* lengths, const int* in_taps,
                      const int* out_taps, const float* gains,
                      const float* refls, const float* damps,
                      float* group_sums, float* out, unsigned int* done,
                      int guides, int lmax, int s, int segs, int groups,
                      int update_blocks, void* stream) {
    last_block_kernel<<<groups + update_blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
        group_sums, out, done, guides, lmax, s, groups, segs);
    return static_cast<int>(cudaGetLastError());
}

// The update blocks alone (groups = 0: no mono block); pairs 4 or 8.
int update_only_launch(const float* x, float* fwd, float* bwd,
                       const int* lengths, const int* in_taps,
                       const int* out_taps, const float* gains,
                       const float* refls, const float* damps, int guides,
                       int lmax, int s, int pairs, int segs,
                       int update_blocks, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (pairs == 4) {
        dwg_block_kernel<4><<<update_blocks, kThreads, 0, st>>>(
            x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
            nullptr, guides, lmax, s, 0, segs);
    } else {
        dwg_block_kernel<8><<<update_blocks, kThreads, 0, st>>>(
            x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
            nullptr, guides, lmax, s, 0, segs);
    }
    return static_cast<int>(cudaGetLastError());
}

// The block kernel's mono blocks alone.
int mono_only_launch(const float* x, float* fwd, float* bwd,
                     const int* lengths, const int* in_taps,
                     const int* out_taps, const float* gains,
                     const float* refls, const float* damps,
                     float* group_sums, int guides, int lmax, int s, int segs,
                     int groups, void* stream) {
    dwg_block_kernel<8><<<groups, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        x, fwd, bwd, lengths, in_taps, out_taps, gains, refls, damps,
        group_sums, guides, lmax, s, groups, segs);
    return static_cast<int>(cudaGetLastError());
}

// which 0: dwg_fold_kernel alone; 1: narrow_fold_kernel alone.
int fold_only_launch(int which, const float* group_sums, float* out,
                     int groups, int s, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (which == 1) {
        return static_cast<int>(
            launch_narrow_fold(group_sums, out, groups, s, false, st));
    }
    dwg_fold_kernel<<<(s + kFoldCols - 1) / kFoldCols,
                      dim3(kFoldCols, kFoldRows), 0, st>>>(group_sums, out,
                                                           groups, s);
    return static_cast<int>(cudaGetLastError());
}

// Blocks an SM: which 0 old update, 1 old sum, 2 shipped block kernel
// (pairs 1, 2, 4, 8, 16 by `pairs`), 3 dwg_fold_kernel, 4
// narrow_fold_kernel, 5 last_block_kernel; negative on a CUDA error.
int stage_occupancy(int which, int pairs) {
    int n = 0;
    cudaError_t err = cudaSuccess;
    switch (which) {
        case 0:
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, old_form::dwg_block_kernel, old_form::kThreads, 0);
            break;
        case 1:
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, old_form::dwg_sum_kernel, 256, 0);
            break;
        case 2:
            err = pairs == 1   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                     &n, dwg_block_kernel<1>, kThreads, 0)
                  : pairs == 2 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                     &n, dwg_block_kernel<2>, kThreads, 0)
                  : pairs == 4 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                     &n, dwg_block_kernel<4>, kThreads, 0)
                  : pairs == 8 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                     &n, dwg_block_kernel<8>, kThreads, 0)
                               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                     &n, dwg_block_kernel<16>, kThreads, 0);
            break;
        case 3:
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, dwg_fold_kernel, kFoldCols * kFoldRows, 0);
            break;
        case 4:
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, narrow_fold_kernel, kNarrowThreads, 0);
            break;
        default:
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, last_block_kernel, kThreads, 0);
    }
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
