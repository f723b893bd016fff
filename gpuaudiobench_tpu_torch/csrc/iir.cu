// Biquad IIR kernels for Hopper (sm_90a), bound through a plain C
// interface (gpuaudiobench_tpu_torch/utils/build.py loads it with ctypes).
//
// Four kernels, one per Pallas kernel of gpuaudiobench_tpu/ops/iir.py.
// Every one keeps the public layout of the JAX functions: x and y are
// (tracks, S) track-major, a filter state is (tracks, 2) = (z1, z2), a
// cascade's states are (K, tracks, 2). Per sample and stage, Direct
// Form II:
//     w = x - a1*z1 - a2*z2,   y = b0*w + b1*z1 + b2*z2,   (z1, z2) <- (w, z1)
//
// * iir_biquad_kernel replaces _iir_kernel (ops/iir.py:49, via
//   iir_biquad_pallas). Bound: bytes. The recurrence is 5 FP32
//   instructions per sample against 8 bytes moved (x read, y written),
//   so at 65,536 x 512 it needs 268 MB of traffic (about 80 us at
//   3.35 TB/s) and 5 us of issue. One thread owns one track, with
//   (z1, z2) in registers for the whole block. The trap is the layout:
//   a thread reading x[t, n] sits S floats from its neighbour and no load
//   would coalesce. So each block stages a (128 tracks x 32 samples) tile
//   through shared memory, loaded and stored along samples by
//   consecutive threads, and the thread walks its row of the tile (the
//   row pitch is odd, so the walk is free of bank conflicts). x is read
//   once and y written once, with no transpose pass in device memory.
//   A block has little else to hide a load's latency behind, so each
//   thread issues all 32 loads of its share of a tile before it stores
//   any (a version that loaded one element at a time ran at a quarter of
//   the bytes bound; PERF.md). The ragged edge of the tracks and of the
//   samples is masked here, where the TPU wrapper padded the tracks to
//   512 and called itself.
// * iir_cascade_chain_kernel<K> replaces _iir_cascade_kernel
//   (ops/iir.py:130, via iir_cascade_pallas_chain): each sample runs
//   through all K stages before the next starts, the same tile scheme,
//   2K states in registers. Its dependency chain per sample is K stages
//   long. The K stages' coefficients and states take up to ~130
//   registers, so the cascades keep 8 loads in flight, not 32.
// * iir_cascade_systolic_kernel<K> replaces _iir_cascade_kernel_systolic
//   (ops/iir.py:161, via iir_cascade_pallas). At step t stage k works on
//   sample t - k, so the K stage updates of a step are independent: one
//   thread holds the skewed K-stage plane in registers, which turns the
//   chain's K-long dependency into K-wide instruction-level parallelism.
//   A live mask (0 <= t - k < S) freezes a stage's state during warm-up
//   and drain, so the carried states land where the chain leaves them.
//   Output lags input by K - 1 samples, so it goes through a second
//   shared-memory tile whose global offset is shifted by K - 1. Each
//   (sample, stage) update is the chain kernel's expression on the same
//   operands, so the two agree to the rounding of FMA contraction.
//   Bound of both cascades: the same bytes as the biquad plus 5K
//   instructions per sample (10 stages: 50, about 50 us of issue at
//   65,536 x 512), so still bytes first.
// * iir_blockstate_kernel<R> replaces _iir_blockstate_kernel
//   (ops/iir.py:407, via iir_biquad_blockstate_pallas). Each m-sample
//   chunk is w = taps @ x_chunk + u0*z1 + u1*z2, then
//   y = b0*w + b1*w[-1] + b2*w[-2], and (z1, z2) = (w[m-1], w[m-2]).
//   Bound: the dense chunk product is m FMAs per sample (at m = 128,
//   2m + 9 = 265 FLOP per sample, about 130 us at 65,536 x 512 and
//   67 TFLOP/s, above the 80 us of its bytes), but the taps are
//   lower-triangular, so the product needs only (m + 1) / 2 FMAs per
//   sample on average (m + 10 = 138 FLOP per sample, about 69 us): the
//   bytes bound it, barely. The JAX kernel runs the product at
//   Precision.HIGHEST and its tests hold it to 1e-5 of the scan, which
//   TF32 tensor cores would not meet, so the product runs in FP32 FMAs:
//   the taps (transposed, 64 KiB at m = 128, in dynamic shared memory)
//   are read as broadcast float4s by a warp whose 32 lanes are 32
//   tracks, and each of the 8 warps of a block owns m/8 rows of w, kept
//   in registers (R per thread), and skips the columns above its rows'
//   diagonal (56 % of the dense FMAs at m = 128). A 3xTF32 wgmma form
//   is later work.
//
// Rounding: nvcc contracts the recurrences into FMAs, which round unlike
// the NumPy golden's separate f32 steps. The models' tolerances (1e-4 on
// the output, 1e-3 on the state) leave room; kernel-vs-twin agreement is
// checked at 1e-5 absolute (tests/test_torch_cuda.py, chip_smoke.py).
//
// Every launch goes on the caller's stream, writes only the outputs the
// wrapper allocated (never the input state), and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kTracks = 128;   // tracks (= threads) per block, tile kernels
constexpr int kChunk = 32;     // samples per shared-memory tile
constexpr int kPitch = kChunk + 1;
constexpr int kBatch = 8;      // global loads in flight per thread (cascades)
constexpr int kMaxStages = 16;

constexpr int kBsWarps = 8;    // blockstate: warps per block (row groups)
constexpr int kBsThreads = kBsWarps * 32;
constexpr int kBsTracks = 32;  // blockstate: tracks per block (lanes)

struct Coeffs {
    float b0, b1, b2, a1, a2;
};

__device__ __forceinline__ Coeffs load_coeffs(const float* c) {
    return Coeffs{c[0], c[1], c[2], c[3], c[4]};
}

// The (kTracks x kChunk) tiles are moved by thread (r0, c) = (tid / kChunk,
// tid % kChunk): it owns sample c of rows r0, r0 + kRowStep, ... A warp
// covers kChunk consecutive samples of one row, so global loads and
// stores coalesce and shared accesses are free of bank conflicts.
constexpr int kRowStep = kTracks / kChunk;

// tile[r][c] = x[t0 + r, n0 + c] for c < len and a track inside T, else 0.
// Loads go kB at a time into registers before any is stored, so kB loads
// are in flight per thread (the biquad takes all kChunk at once; the
// cascades, which hold their stages in registers, fewer).
template <int kB>
__device__ __forceinline__ void load_tile(float (*tile)[kPitch],
                                          const float* __restrict__ x,
                                          long long t0, int tracks, int s,
                                          int n0, int len) {
    const int c = threadIdx.x % kChunk;
    const int r0 = threadIdx.x / kChunk;
    const long long step = static_cast<long long>(kRowStep) * s;
    const float* p = x + (t0 + r0) * s + n0 + c;
    const long long rows_left = tracks - t0 - r0;  // rows r0 + q*kRowStep
#pragma unroll 1
    for (int q0 = 0; q0 < kChunk; q0 += kB) {
        float v[kB];
#pragma unroll
        for (int q = 0; q < kB; ++q) {
            const int dq = q0 + q;
            v[q] = (c < len && dq * kRowStep < rows_left) ? p[dq * step] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kB; ++q) tile[r0 + (q0 + q) * kRowStep][c] = v[q];
    }
}

// y[t0 + r, n0 + c] = tile[r][c] for 0 <= n0 + c < s, c < len, t < T.
__device__ __forceinline__ void store_tile(float* __restrict__ y,
                                           float (*tile)[kPitch],
                                           long long t0, int tracks, int s,
                                           int n0, int len) {
    const int c = threadIdx.x % kChunk;
    const int r0 = threadIdx.x / kChunk;
    const int n = n0 + c;
    if (c >= len || n < 0 || n >= s) return;
    const long long step = static_cast<long long>(kRowStep) * s;
    float* p = y + (t0 + r0) * s + n;
    const long long rows_left = tracks - t0 - r0;
#pragma unroll 8
    for (int q = 0; q < kChunk; ++q) {
        if (q * kRowStep < rows_left) p[q * step] = tile[r0 + q * kRowStep][c];
    }
}

__global__ void __launch_bounds__(kTracks)
iir_biquad_kernel(const float* __restrict__ x, const float* __restrict__ coeffs,
                  const float* __restrict__ z_in, float* __restrict__ y,
                  float* __restrict__ z_out, int tracks, int s) {
    __shared__ float tile[kTracks][kPitch];
    const long long t0 = static_cast<long long>(blockIdx.x) * kTracks;
    const long long t = t0 + threadIdx.x;
    const bool live = t < tracks;
    const Coeffs c = load_coeffs(coeffs);
    float z1 = live ? z_in[2 * t] : 0.f;
    float z2 = live ? z_in[2 * t + 1] : 0.f;
    for (int n0 = 0; n0 < s; n0 += kChunk) {
        const int len = min(kChunk, s - n0);
        load_tile<kChunk>(tile, x, t0, tracks, s, n0, len);
        __syncthreads();
        float* row = tile[threadIdx.x];
        for (int j = 0; j < len; ++j) {
            const float w = row[j] - c.a1 * z1 - c.a2 * z2;
            row[j] = c.b0 * w + c.b1 * z1 + c.b2 * z2;
            z2 = z1;
            z1 = w;
        }
        __syncthreads();
        store_tile(y, tile, t0, tracks, s, n0, len);
        __syncthreads();
    }
    if (live) {
        z_out[2 * t] = z1;
        z_out[2 * t + 1] = z2;
    }
}

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

template <int K>
__global__ void __launch_bounds__(kTracks)
iir_cascade_chain_kernel(const float* __restrict__ x,
                         const float* __restrict__ coeffs,
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

template <int K>
__global__ void __launch_bounds__(kTracks)
iir_cascade_systolic_kernel(const float* __restrict__ x,
                            const float* __restrict__ coeffs,
                            const float* __restrict__ z_in,
                            float* __restrict__ y, float* __restrict__ z_out,
                            int tracks, int s) {
    __shared__ float in_tile[kTracks][kPitch];
    __shared__ float out_tile[kTracks][kPitch];
    const long long t0 = static_cast<long long>(blockIdx.x) * kTracks;
    const long long t = t0 + threadIdx.x;
    const bool live = t < tracks;
    Coeffs c[K];
    float z1[K], z2[K], ylast[K];
    load_stages<K>(coeffs, z_in, t, tracks, live, c, z1, z2);
#pragma unroll
    for (int k = 0; k < K; ++k) ylast[k] = 0.f;

    // Step t works on input sample t; stage K-1 emits sample t - (K-1).
    const int steps = s + K - 1;
    for (int n0 = 0; n0 < steps; n0 += kChunk) {
        const int len = min(kChunk, steps - n0);
        load_tile<kBatch>(in_tile, x, t0, tracks, s, n0, min(len, max(s - n0, 0)));
        __syncthreads();
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
        __syncthreads();
        // out_tile[r][j] is output sample n0 + j - (K - 1).
        store_tile(y, out_tile, t0, tracks, s, n0 - (K - 1), len);
        __syncthreads();
    }
    if (live) store_stages<K>(z_out, t, tracks, z1, z2);
}

// Shared memory of the blockstate kernel, as offsets in floats.
struct BsLayout {
    int m, mp, pitch;
    int taps, u, tile, z, total;
    __host__ __device__ BsLayout(int m_, int rows_per_thread)
        : m(m_), mp(kBsWarps * rows_per_thread + 4), pitch(m_ | 1) {
        // taps_t[i][j], (m, mp): j padded past the 8 warps' rows by 4, which
        // keeps rows 16-byte aligned and spreads a column over 8 banks.
        taps = 0;
        u = taps + m * mp;                // u[j][2]
        tile = u + 2 * m;                 // x chunk, then w: (32, pitch)
        z = tile + kBsTracks * pitch;     // entering (z1, z2) per track
        total = z + 2 * kBsTracks;
    }
};

template <int R>
__global__ void __launch_bounds__(kBsThreads)
iir_blockstate_kernel(const float* __restrict__ x,
                      const float* __restrict__ coeffs,
                      const float* __restrict__ taps,
                      const float* __restrict__ u,
                      const float* __restrict__ z_in, float* __restrict__ y,
                      float* __restrict__ z_out, int tracks, int s, int m) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const BsLayout L(m, R);
    float* taps_t = smem + L.taps;
    float* us = smem + L.u;
    float* tile = smem + L.tile;
    float* zs = smem + L.z;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long t0 = static_cast<long long>(blockIdx.x) * kBsTracks;

    // taps_t[i][j] = taps[j][i], columns j >= m zero. taps is read
    // coalesced, kBatch loads in flight per thread; the transposed
    // shared store is bank-conflicted, a one-time cost per block.
    const int mm = m * m;
    for (int e0 = threadIdx.x; e0 < mm; e0 += kBatch * kBsThreads) {
        float v[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
            const int e = e0 + q * kBsThreads;
            v[q] = (e < mm) ? taps[e] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
            const int e = e0 + q * kBsThreads;
            if (e < mm) taps_t[(e % m) * L.mp + e / m] = v[q];
        }
    }
    const int pad = L.mp - m;
    for (int e = threadIdx.x; e < m * pad; e += kBsThreads) {
        taps_t[(e / pad) * L.mp + m + e % pad] = 0.f;
    }
    for (int e = threadIdx.x; e < 2 * m; e += kBsThreads) us[e] = u[e];
    if (threadIdx.x < kBsTracks) {
        const long long t = t0 + threadIdx.x;
        zs[2 * threadIdx.x] = (t < tracks) ? z_in[2 * t] : 0.f;
        zs[2 * threadIdx.x + 1] = (t < tracks) ? z_in[2 * t + 1] : 0.f;
    }
    const float b0 = coeffs[0], b1 = coeffs[1], b2 = coeffs[2];
    const int j0 = warp * R;  // this thread's rows j0 .. j0 + R - 1

    for (int n0 = 0; n0 < s; n0 += m) {
        // The (32 tracks x m) chunk of x, coalesced along samples, kBatch
        // loads in flight per thread.
        const int n_tile = kBsTracks * m;
        for (int e0 = threadIdx.x; e0 < n_tile; e0 += kBatch * kBsThreads) {
            float v[kBatch];
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
                const int e = e0 + q * kBsThreads;
                const long long t = t0 + e / m;
                v[q] = (e < n_tile && t < tracks) ? x[t * s + n0 + e % m] : 0.f;
            }
#pragma unroll
            for (int q = 0; q < kBatch; ++q) {
                const int e = e0 + q * kBsThreads;
                if (e < n_tile) tile[(e / m) * L.pitch + e % m] = v[q];
            }
        }
        __syncthreads();

        // acc[r] = sum_i taps[j0 + r][i] * x[lane][i], i ascending. The
        // taps are lower-triangular, so rows j0 .. j0 + R - 1 need only
        // i < j0 + R: the terms skipped are exact zeros.
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
        const float* xrow = tile + lane * L.pitch;
        const int i_end = min(m, j0 + R);
        for (int i = 0; i < i_end; ++i) {
            const float xi = xrow[i];
            const float* trow = taps_t + i * L.mp + j0;
            if constexpr (R % 4 == 0) {
#pragma unroll
                for (int r = 0; r < R; r += 4) {
                    const float4 tv = *reinterpret_cast<const float4*>(trow + r);
                    acc[r] = fmaf(tv.x, xi, acc[r]);
                    acc[r + 1] = fmaf(tv.y, xi, acc[r + 1]);
                    acc[r + 2] = fmaf(tv.z, xi, acc[r + 2]);
                    acc[r + 3] = fmaf(tv.w, xi, acc[r + 3]);
                }
            } else {
#pragma unroll
                for (int r = 0; r < R; ++r) acc[r] = fmaf(trow[r], xi, acc[r]);
            }
        }
        const float z1 = zs[2 * lane];
        const float z2 = zs[2 * lane + 1];
        __syncthreads();  // every x read is done: the tile now takes w
        float* wrow = tile + lane * L.pitch;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int j = j0 + r;
            if (j < m) {
                wrow[j] = acc[r] + us[2 * j] * z1 + us[2 * j + 1] * z2;
            }
        }
        __syncthreads();

        // y[t, n0 + j] from w[j], w[j-1], w[j-2] (entering state for j < 2).
        for (int e = threadIdx.x; e < kBsTracks * m; e += kBsThreads) {
            const int r = e / m;
            const int j = e - r * m;
            const long long t = t0 + r;
            const float* w = tile + r * L.pitch;
            const float wm1 = (j >= 1) ? w[j - 1] : zs[2 * r];
            const float wm2 = (j >= 2) ? w[j - 2] : (j == 1 ? zs[2 * r] : zs[2 * r + 1]);
            if (t < tracks) y[t * s + n0 + j] = b0 * w[j] + b1 * wm1 + b2 * wm2;
        }
        __syncthreads();
        if (threadIdx.x < kBsTracks) {
            const float* w = tile + threadIdx.x * L.pitch;
            zs[2 * threadIdx.x] = w[m - 1];
            zs[2 * threadIdx.x + 1] = w[m - 2];
        }
        __syncthreads();
    }
    if (threadIdx.x < kBsTracks) {
        const long long t = t0 + threadIdx.x;
        if (t < tracks) {
            z_out[2 * t] = zs[2 * threadIdx.x];
            z_out[2 * t + 1] = zs[2 * threadIdx.x + 1];
        }
    }
}

int grid_for(int tracks, int per_block) {
    return (tracks + per_block - 1) / per_block;
}

template <int K>
cudaError_t launch_cascade(const float* x, const float* coeffs,
                           const float* z_in, float* y, float* z_out,
                           int tracks, int s, bool systolic, cudaStream_t st) {
    const int blocks = grid_for(tracks, kTracks);
    if (systolic) {
        iir_cascade_systolic_kernel<K><<<blocks, kTracks, 0, st>>>(
            x, coeffs, z_in, y, z_out, tracks, s);
    } else {
        iir_cascade_chain_kernel<K><<<blocks, kTracks, 0, st>>>(
            x, coeffs, z_in, y, z_out, tracks, s);
    }
    return cudaGetLastError();
}

template <int R>
cudaError_t launch_blockstate(const float* x, const float* coeffs,
                              const float* taps, const float* u,
                              const float* z_in, float* y, float* z_out,
                              int tracks, int s, int m, cudaStream_t st) {
    const size_t bytes = static_cast<size_t>(BsLayout(m, R).total) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        iir_blockstate_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    iir_blockstate_kernel<R><<<grid_for(tracks, kBsTracks), kBsThreads,
                               bytes, st>>>(
        x, coeffs, taps, u, z_in, y, z_out, tracks, s, m);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest cascade depth the kernels are built for.
int iir_max_stages() { return kMaxStages; }

// x, y: (tracks, s); coeffs: (5,) = b0, b1, b2, a1, a2; z_in, z_out:
// (tracks, 2). No output may alias an input.
int iir_biquad_launch(const float* x, const float* coeffs, const float* z_in,
                      float* y, float* z_out, int tracks, int s, void* stream) {
    if (tracks <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
    iir_biquad_kernel<<<grid_for(tracks, kTracks), kTracks, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        x, coeffs, z_in, y, z_out, tracks, s);
    return static_cast<int>(cudaGetLastError());
}

// coeffs: (k, 5); z_in, z_out: (k, tracks, 2); systolic selects the
// skewed form (else the per-sample chain). 1 <= k <= iir_max_stages().
int iir_cascade_launch(const float* x, const float* coeffs, const float* z_in,
                       float* y, float* z_out, int tracks, int s, int k,
                       int systolic, void* stream) {
    if (tracks <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool sys = systolic != 0;
    cudaError_t err;
    switch (k) {
#define IIR_CASE(N) \
    case N: err = launch_cascade<N>(x, coeffs, z_in, y, z_out, tracks, s, sys, st); break;
        IIR_CASE(1) IIR_CASE(2) IIR_CASE(3) IIR_CASE(4) IIR_CASE(5) IIR_CASE(6)
        IIR_CASE(7) IIR_CASE(8) IIR_CASE(9) IIR_CASE(10) IIR_CASE(11)
        IIR_CASE(12) IIR_CASE(13) IIR_CASE(14) IIR_CASE(15) IIR_CASE(16)
#undef IIR_CASE
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err);
}

// taps: (m, m) row-major, u: (m, 2), from blockstate_tables; coeffs: (5,)
// (only b0, b1, b2 are read). 2 <= m <= 128 and m divides s.
int iir_blockstate_launch(const float* x, const float* coeffs,
                          const float* taps, const float* u, const float* z_in,
                          float* y, float* z_out, int tracks, int s, int m,
                          void* stream) {
    if (tracks <= 0 || s <= 0 || m < 2 || m > 128 || s % m != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int rows = (m + kBsWarps - 1) / kBsWarps;  // rows per thread
    cudaError_t err;
    if (rows <= 1) {
        err = launch_blockstate<1>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    } else if (rows <= 2) {
        err = launch_blockstate<2>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    } else if (rows <= 4) {
        err = launch_blockstate<4>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    } else if (rows <= 8) {
        err = launch_blockstate<8>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    } else {
        err = launch_blockstate<16>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    }
    return static_cast<int>(err);
}

}  // extern "C"
