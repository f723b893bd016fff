// Measurements behind PERF.md's account of the two biquad cascades
// (csrc/iir.cu): for each, the kernel as it shipped before its redesign,
// the redesigned kernel (included) and its variants, all built into one
// library with a plain C interface. run.py (beside this file) builds it
// twice with nvcc, once with -DCASCADE_PROFILE, which turns the
// redesigned kernels' CASCADE_MARK and CHAIN_MARK hooks into clock64()
// phase sums, and drives both on one CUDA device. Nothing of the port
// loads this file.
//
// The systolic cascade (run.py --part systolic):
// * old_cascade_launch: the one-thread-a-track kernel, 128 tracks a
//   block, two tiles through __syncthreads() per 32-step chunk, the live
//   mask on every (step, stage), as it was (K = 1, 2, 10, 16);
//   old_cascade_profile: the same at K = 10 with clock64() phase sums.
// * iir_cascade_launch (csrc/iir.cu, included): the kernel as shipped;
//   under CASCADE_PROFILE, with phase sums (cascade_prof_set).
// * variant_launch: the shipped kernel's template at K = 10 with other
//   (warps a block, ring depth, steady quads a pass), on the same
//   schedule rule.
//
// The per-sample chain cascade (run.py --part chain):
// * old_chain_launch: the one-thread-a-track chain kernel as it shipped
//   before its redesign (128 tracks a block, a 33-float pitch tile through
//   three __syncthreads() a chunk, 8 loads in flight a thread, the 5K
//   coefficients in registers), at every K from 1 to 16.
// * iir_cascade_chain_launch (csrc/iir.cu, included): the shipped kernel
//   on either route; under CASCADE_PROFILE with phase sums
//   (chain_prof_set).
// * chain_variant_launch: the shipped kernel at K = 10 on the TMA route
//   without the constant bank (the coefficients in registers) or without
//   the ring (one tile a warp), and its copies alone (chain_copy_kernel).

#include <cuda_runtime.h>

#include <cstdint>

#ifdef CASCADE_PROFILE
// 8 int64 a warp, block-major: [0] the warp's total cycles, [q] the
// cycles of phase q (1..7, see csrc/iir.cu), one array a kernel.
__device__ long long* g_cascade_prof;
__device__ long long* g_chain_prof;

__device__ __forceinline__ void phase_mark(long long* prof, int q) {
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
        long long* dst = prof + (static_cast<long long>(blockIdx.x) *
                                 (blockDim.x >> 5) + warp) * 8;
        dst[0] = now - sums[warp][0];
        for (int i = 1; i < 8; ++i) dst[i] = sums[warp][i];
    }
}
#define CASCADE_MARK(q) phase_mark(g_cascade_prof, q)
#define CHAIN_MARK(q) phase_mark(g_chain_prof, q)
#endif

#include "../../gpuaudiobench_tpu_torch/csrc/iir.cu"

namespace {

constexpr int kBatch = 8;  // global loads in flight per thread (old cascades)

template <int K>
__device__ __forceinline__ void load_stages(const float* __restrict__ coeffs,
                                            const float* __restrict__ z_in,
                                            long long t, int tracks, bool live,
                                            Coeffs (&c)[K], float (&z1)[K],
                                            float (&z2)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        c[k] = load_coeffs(coeffs + 5 * k);
        const long long base = (static_cast<long long>(k) * tracks + t) * 2;
        z1[k] = live ? z_in[base] : 0.f;
        z2[k] = live ? z_in[base + 1] : 0.f;
    }
}

template <int K>
__device__ __forceinline__ void store_stages(float* __restrict__ z_out,
                                             long long t, int tracks,
                                             const float (&z1)[K],
                                             const float (&z2)[K]) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const long long base = (static_cast<long long>(k) * tracks + t) * 2;
        z_out[base] = z1[k];
        z_out[base + 1] = z2[k];
    }
}

}  // namespace

namespace old_form {

// The chain cascade as it shipped before its redesign.
template <int K>
__global__ void __launch_bounds__(kTracks)
old_chain_kernel(const float* __restrict__ x, const float* __restrict__ coeffs,
                 const float* __restrict__ z_in, float* __restrict__ y,
                 float* __restrict__ z_out, int tracks, int s) {
    __shared__ float tile[kTracks][kPitch];
    const long long t0 = static_cast<long long>(blockIdx.x) * kTracks;
    const long long t = t0 + threadIdx.x;
    const bool live = t < tracks;
    Coeffs c[K];
    float z1[K], z2[K];
    load_stages<K>(coeffs, z_in, t, tracks, live, c, z1, z2);
    for (int n0 = 0; n0 < s; n0 += kChunk) {
        const int len = min(kChunk, s - n0);
        load_tile<kBatch>(tile, x, t0, tracks, s, n0, len);
        __syncthreads();
        float* row = tile[threadIdx.x];
        for (int j = 0; j < len; ++j) {
            float v = row[j];
#pragma unroll
            for (int k = 0; k < K; ++k) {
                const float w = v - c[k].a1 * z1[k] - c[k].a2 * z2[k];
                v = c[k].b0 * w + c[k].b1 * z1[k] + c[k].b2 * z2[k];
                z2[k] = z1[k];
                z1[k] = w;
            }
            row[j] = v;
        }
        __syncthreads();
        store_tile(y, tile, t0, tracks, s, n0, len);
        __syncthreads();
    }
    if (live) store_stages<K>(z_out, t, tracks, z1, z2);
}


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

// The shipped chain kernel's copies alone: each warp's chunk tiles go
// through the same TMA ring (loads onto mbarriers, stores from the tile,
// the slot refilled one chunk after its store) with no stages between:
// y = x, the floor of the tile pattern.
__global__ void __launch_bounds__(kChWarps * 32, 4)
chain_copy_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap y_map, int tracks, int chunks) {
    constexpr int R = kChRing;
    extern __shared__ float4 ch_smem4[];
    __shared__ uint64_t full[kChWarps][R];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int t0 = (blockIdx.x * kChWarps + warp) * 32;
    if (t0 >= tracks) return;
    const uint32_t raw = ch_smem(ch_smem4);
    float* ring = reinterpret_cast<float*>(
                      reinterpret_cast<char*>(ch_smem4) +
                      (((raw + kChAlign - 1) & ~static_cast<uint32_t>(kChAlign - 1)) - raw)) +
                  warp * R * kChTile;
    uint64_t* bar = full[warp];
    if (lane == 0) {
        for (int r = 0; r < R; ++r) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(ch_smem(&bar[r]))
                         : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int c = 0; c < R && c < chunks; ++c) {
            ch_tma_load(ring + c * kChTile, &x_map, &bar[c], 32 * c, t0);
        }
    }
    __syncwarp();
    for (int c = 0; c < chunks; ++c) {
        float* tile = ring + (c % R) * kChTile;
        ch_wait(&bar[c % R], (c / R) & 1);
        __syncwarp();
        if (lane == 0) {
            ch_tma_store(&y_map, tile, 32 * c, t0);
            const int old = c - 1;
            if (old >= 0 && old + R < chunks) {
                asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
                ch_tma_load(ring + (old % R) * kChTile, &x_map, &bar[old % R],
                            32 * (old + R), t0);
            }
        }
    }
    if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

int chain_copy(const float* x, float* y, int tracks, int s, cudaStream_t st) {
    CUtensorMap xm{}, ym{};
    cudaError_t err = chain_map(&xm, x, tracks, s);
    if (err == cudaSuccess) err = chain_map(&ym, y, tracks, s);
    constexpr int bytes = kChRing * kChWarps * kChTileBytes + kChAlign;
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(chain_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
    }
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(chain_copy_kernel,
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    chain_copy_kernel<<<grid_for(tracks, kChWarps * 32), kChWarps * 32, bytes, st>>>(
        xm, ym, tracks, (s + 31) / 32);
    return static_cast<int>(cudaGetLastError());
}

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


int old_chain_launch(const float* x, const float* coeffs, const float* z_in, float* y,
                     float* z_out, int tracks, int s, int k, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int blocks = grid_for(tracks, kTracks);
    switch (k) {
#define OLD_CHAIN(N)                                                                   \
    case N:                                                                            \
        old_form::old_chain_kernel<N><<<blocks, kTracks, 0, st>>>(x, coeffs, z_in, y,  \
                                                                  z_out, tracks, s);   \
        break;
        OLD_CHAIN(1) OLD_CHAIN(2) OLD_CHAIN(3) OLD_CHAIN(4) OLD_CHAIN(5) OLD_CHAIN(6)
        OLD_CHAIN(7) OLD_CHAIN(8) OLD_CHAIN(9) OLD_CHAIN(10) OLD_CHAIN(11) OLD_CHAIN(12)
        OLD_CHAIN(13) OLD_CHAIN(14) OLD_CHAIN(15) OLD_CHAIN(16)
#undef OLD_CHAIN
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// Blocks an SM (occupancy API) at depth k (1, 10, 16): the old chain
// kernel (route < 0), the shipped kernel on route 0 (TMA) or 1 (staged),
// with the dynamic shared memory its launcher asks for.
int chain_occupancy(int k, int route) {
    int n = 0;
    cudaError_t err = cudaErrorInvalidValue;
#define CHAIN_OCC(N)                                                                     \
    if (k == N) {                                                                        \
        if (route < 0) {                                                                 \
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                         \
                &n, old_form::old_chain_kernel<N>, kTracks, 0);                          \
        } else {                                                                         \
            const int bytes = (route == 0 ? kChRing : 1) * kChWarps * kChTileBytes + kChAlign; \
            auto kernel = route == 0 ? iir_cascade_chain_kernel<N, true, kChRing, true>  \
                                     : iir_cascade_chain_kernel<N, false, 1, true>;      \
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                       bytes);                                           \
            if (err == cudaSuccess) {                                                    \
                err = cudaFuncSetAttribute(kernel,                                       \
                                           cudaFuncAttributePreferredSharedMemoryCarveout, \
                                           cudaSharedmemCarveoutMaxShared);              \
            }                                                                            \
            if (err == cudaSuccess) {                                                    \
                err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,          \
                                                                    kChWarps * 32, bytes); \
            }                                                                            \
        }                                                                                \
    }
    CHAIN_OCC(1) CHAIN_OCC(10) CHAIN_OCC(16)
#undef CHAIN_OCC
    return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The shipped chain kernel at K = 10 on the TMA route, variant 0 without
// the constant bank (coefficients in registers), 1 without the ring (one
// tile a warp), on the shipped geometry; variant 2 its copies alone
// (chain_copy_kernel: y = x, the states untouched).
int chain_variant_launch(int v, const float* x, const float* coeffs, const float* z_in,
                         float* y, float* z_out, int tracks, int s, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int grid = grid_for(tracks, kChWarps * 32), chunks = (s + 31) / 32;
    switch (v) {
        case 0: return static_cast<int>(launch_chain<10, true, kChRing, false>(
                    x, coeffs, z_in, y, z_out, tracks, s, grid, chunks, st));
        case 1: return static_cast<int>(launch_chain<10, true, 1, true>(
                    x, coeffs, z_in, y, z_out, tracks, s, grid, chunks, st));
        case 2: return s % 4 == 0 ? chain_copy(x, y, tracks, s, st)
                                  : static_cast<int>(cudaErrorInvalidValue);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

#ifdef CASCADE_PROFILE
int cascade_prof_set(long long* p) {
    return static_cast<int>(cudaMemcpyToSymbol(g_cascade_prof, &p, sizeof(p)));
}

int chain_prof_set(long long* p) {
    return static_cast<int>(cudaMemcpyToSymbol(g_chain_prof, &p, sizeof(p)));
}
#endif

}  // extern "C"
