// Measurements behind PERF.md's account of the blockstate kernel
// (csrc/iir.cu): the kernel as it shipped before its redesign, the two
// stages of the redesign, an instrumented copy of the redesigned kernel
// and a tensor-pipe probe, all built into one library with a plain C
// interface. run.py (beside this file) builds it with nvcc and drives it
// on one CUDA device. Nothing of the port loads this file.
//
// * old_blockstate_launch: the one-block-per-32-tracks FP32 kernel (8
//   warps, each a band of rows of the triangular product, five block
//   barriers a chunk), as it was; old_blockstate_profile: the same with
//   clock64() phase counters.
// * stage_launch(variant 1): stage A, the redesign's structure (a
//   persistent grid, one block of 8 warps an SM, 16 tracks a warp, a
//   2-stage cp.async ring per warp, no block barrier in the loop) with the
//   product in FP32 FMAs.
// * stage_launch(variant 2): stage B's first form, 3xTF32 mma.sync with
//   the x chunk as the A operand (16 tracks a warp) and the taps as B.
// * stage_launch(variant 3): the kernel of csrc/iir.cu (taps as A, 8
//   tracks a warp, 16 warps), with clock64() phase counters per warp.
// * iir_blockstate_launch (csrc/iir.cu, included): the kernel as shipped.
// * hmma_probe: independent HMMA.1688.F32.TF32 chains, for the tensor
//   pipe's rate and latency.

#include "../../gpuaudiobench_tpu_torch/csrc/iir.cu"

namespace old_form {

constexpr int kBsWarps = 8;
constexpr int kBsThreads = kBsWarps * 32;
constexpr int kBsTracks = 32;
constexpr int kBatch = 8;

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

// kProf adds clock64() phase sums per warp (lane 0 writes 8 int64 at
// prof + 8 * (block * 8 + warp)); kProf = false is the kernel as it was.
template <int R, bool kProf = false>
__global__ void __launch_bounds__(kBsThreads)
iir_blockstate_kernel(const float* __restrict__ x,
                      const float* __restrict__ coeffs,
                      const float* __restrict__ taps,
                      const float* __restrict__ u,
                      const float* __restrict__ z_in, float* __restrict__ y,
                      float* __restrict__ z_out, int tracks, int s, int m,
                      long long* __restrict__ prof = nullptr) {
    long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    long long ck = kProf ? clock64() : 0;
    auto mark = [&](int q) {
        if constexpr (kProf) {
            const long long now = clock64();
            ph[q] += now - ck;
            ck = now;
        }
    };
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
    mark(0);

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
        mark(1);

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
        mark(2);
        __syncthreads();  // every x read is done: the tile now takes w
        mark(3);
        float* wrow = tile + lane * L.pitch;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int j = j0 + r;
            if (j < m) {
                wrow[j] = acc[r] + us[2 * j] * z1 + us[2 * j + 1] * z2;
            }
        }
        __syncthreads();
        mark(4);

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
        mark(5);
        if (threadIdx.x < kBsTracks) {
            const float* w = tile + threadIdx.x * L.pitch;
            zs[2 * threadIdx.x] = w[m - 1];
            zs[2 * threadIdx.x + 1] = w[m - 2];
        }
        __syncthreads();
        mark(6);
    }
    if constexpr (kProf) {
        if (lane == 0) {
            long long* p = prof + (static_cast<long long>(blockIdx.x) * kBsWarps + warp) * 8;
            for (int q = 0; q < 7; ++q) p[q] = ph[q];
            p[7] = 1;
        }
    }
    if (threadIdx.x < kBsTracks) {
        const long long t = t0 + threadIdx.x;
        if (t < tracks) {
            z_out[2 * t] = zs[2 * threadIdx.x];
            z_out[2 * t + 1] = zs[2 * threadIdx.x + 1];
        }
    }
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
    iir_blockstate_kernel<R><<<(tracks + kBsTracks - 1) / kBsTracks, kBsThreads,
                               bytes, st>>>(
        x, coeffs, taps, u, z_in, y, z_out, tracks, s, m);
    return cudaGetLastError();
}

// The instrumented instance at m = 128 (R = 16).
cudaError_t launch_profiled(const float* x, const float* coeffs, const float* taps,
                            const float* u, const float* z_in, float* y, float* z_out,
                            int tracks, int s, long long* prof, cudaStream_t st) {
    const int bytes = BsLayout(128, 16).total * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        iir_blockstate_kernel<16, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    iir_blockstate_kernel<16, true><<<(tracks + kBsTracks - 1) / kBsTracks, kBsThreads,
                                      bytes, st>>>(
        x, coeffs, taps, u, z_in, y, z_out, tracks, s, 128, prof);
    return cudaGetLastError();
}

}  // namespace old_form

namespace stages {

constexpr int kStages = 2;

__device__ __forceinline__ uint32_t tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
    return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// acc[n] = rows (g, g + 8) x cols (8n + 2t, 8n + 2t + 1) of x_tile @ taps^T.
template <int NT>
__device__ __forceinline__ void product_tc(float (&acc)[NT][4], const float* xs,
                                           const uint4* frag, int lane) {
    constexpr int kPitch = 8 * NT + 4;
    const int g = lane >> 2, t = lane & 3;
    const float* ra = xs + g * kPitch + t;
    const float* rb = ra + 8 * kPitch;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < NT; ++k) {
        const float v[4] = {ra[8 * k], rb[8 * k], ra[8 * k + 4], rb[8 * k + 4]};
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            ah[q] = tf32(v[q]);
            al[q] = tf32(v[q] - __uint_as_float(ah[q]));
        }
#pragma unroll
        for (int n = k; n < NT; ++n) {
            const int step = k * NT - k * (k - 1) / 2 + (n - k);
            const uint4 b = frag[step * 32 + lane];  // b0 hi, b1 hi, b0 lo, b1 lo
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(d, al, b.x, b.y);
            mma_tf32(d, ah, b.z, b.w);
            mma_tf32(d, ah, b.x, b.y);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[n][q] += d[q];
        }
    }
}

template <int NT>
__device__ __forceinline__ void product_fma(float (&acc)[NT][4], const float* xs,
                                            const float* tp, int lane) {
    constexpr int kPitch = 8 * NT + 4;
    const int g = lane >> 2, t = lane & 3;
    const float* ra = xs + g * kPitch;
    const float* rb = ra + 8 * kPitch;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[n][q] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < NT; ++k) {
        float xa[8], xb[8];
        *reinterpret_cast<float4*>(xa) = *reinterpret_cast<const float4*>(ra + 8 * k);
        *reinterpret_cast<float4*>(xa + 4) = *reinterpret_cast<const float4*>(ra + 8 * k + 4);
        *reinterpret_cast<float4*>(xb) = *reinterpret_cast<const float4*>(rb + 8 * k);
        *reinterpret_cast<float4*>(xb + 4) = *reinterpret_cast<const float4*>(rb + 8 * k + 4);
#pragma unroll
        for (int n = k; n < NT; ++n) {
            const float* t0 = tp + (8 * n + 2 * t) * kPitch + 8 * k;
            const float* t1 = t0 + kPitch;
            float c0[8], c1[8];
            *reinterpret_cast<float4*>(c0) = *reinterpret_cast<const float4*>(t0);
            *reinterpret_cast<float4*>(c0 + 4) = *reinterpret_cast<const float4*>(t0 + 4);
            *reinterpret_cast<float4*>(c1) = *reinterpret_cast<const float4*>(t1);
            *reinterpret_cast<float4*>(c1 + 4) = *reinterpret_cast<const float4*>(t1 + 4);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                acc[n][0] = fmaf(c0[i], xa[i], acc[n][0]);
                acc[n][1] = fmaf(c1[i], xa[i], acc[n][1]);
                acc[n][2] = fmaf(c0[i], xb[i], acc[n][2]);
                acc[n][3] = fmaf(c1[i], xb[i], acc[n][3]);
            }
        }
    }
}

// Tensor-pipe probe: independent HMMA.1688.F32.TF32 chains, 8 a warp.
__global__ void hmma_probe_kernel(float* out, int iters) {
    uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
    float d[8][4] = {};
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int c = 0; c < 8; ++c) mma_tf32(d[c], a, 0x3f800000u + c, 0x3f800000u);
    }
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) sum += d[c][0] + d[c][1] + d[c][2] + d[c][3];
    if (sum == 1234.5f) out[threadIdx.x] = sum;
}

// The stage kernels: a persistent grid, each warp a group of kRows tracks
// walking its (group, chunk) items with a 2-stage cp.async ring. MODE 0:
// stage A, FP32 FMAs, 16 tracks a warp, 8 warps. MODE 1: stage B's first
// form, 3xTF32 with x as A, 16 tracks a warp, 8 warps. MODE 2: the kernel
// of csrc/iir.cu (its bs_product), 8 tracks a warp, 16 warps. Per warp,
// clock64() sums of each phase go to prof (when not null); product_only
// skips the copies, y and the state, and reruns the product on stage 0.
template <int NT, int MODE>
struct Cfg {
    static constexpr int kRows = MODE == 2 ? kBsRows : 16;
    static constexpr int kWarps = MODE == 2 ? kBsWarps : 8;
    static constexpr int kThreads = kWarps * 32;
    static constexpr int kPitch = 8 * NT + 4;
    static constexpr int kTile = kRows * kPitch;
    static constexpr int taps_floats() {
        return MODE == 0 ? 8 * NT * kPitch
             : MODE == 1 ? (NT * (NT + 1) / 2) * 32 * 4
                         : BsShape<NT>::steps() * 32 * 8;
    }
    static constexpr int u = taps_floats();
    static constexpr int stage = u + 16 * NT;
    static constexpr int zs = stage + kWarps * kStages * kTile;
    static constexpr int total = zs + kWarps * kRows * 2;
};

__device__ __forceinline__ long long clk() { return clock64(); }

template <int NT, int MODE>
__global__ void __launch_bounds__(Cfg<NT, MODE>::kThreads, 1)
stage_kernel(const float* __restrict__ x, const float* __restrict__ coeffs,
             const float* __restrict__ taps, const float* __restrict__ u,
             const float* __restrict__ z_in, float* __restrict__ y,
             float* __restrict__ z_out, int tracks, int s, int m, int vec,
             int product_only, long long* __restrict__ prof) {
    using C = Cfg<NT, MODE>;
    constexpr int kRows = C::kRows;
    constexpr int kWarps = C::kWarps;
    constexpr int kMp = 8 * NT;
    constexpr int kPitch = C::kPitch;
    constexpr int kTile = C::kTile;
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    long long tp0 = clk(), t_issue = 0, t_wait = 0, t_prod = 0, t_y = 0, t_tail = 0;

    if constexpr (MODE == 1) {
        uint4* frag = reinterpret_cast<uint4*>(smem);
        constexpr int kSteps = NT * (NT + 1) / 2;
        for (int e = threadIdx.x; e < kSteps * 32; e += blockDim.x) {
            const int l = e & 31;
            int k = 0, rem = e >> 5;
            while (rem >= NT - k) {
                rem -= NT - k;
                ++k;
            }
            const int j = 8 * (k + rem) + (l >> 2);
            const int i0 = 8 * k + (l & 3), i1 = i0 + 4;
            const float v0 = (j < m && i0 < m) ? taps[j * m + i0] : 0.f;
            const float v1 = (j < m && i1 < m) ? taps[j * m + i1] : 0.f;
            const uint32_t h0 = tf32(v0), h1 = tf32(v1);
            frag[e] = make_uint4(h0, h1, tf32(v0 - __uint_as_float(h0)),
                                 tf32(v1 - __uint_as_float(h1)));
        }
    } else if constexpr (MODE == 2) {
        constexpr int MT = NT / 2;
        constexpr int kSteps = BsShape<NT>::steps();
        uint4* hi = reinterpret_cast<uint4*>(smem);
        uint4* lo = hi + kSteps * 32;
        for (int e = threadIdx.x; e < kSteps * 32; e += blockDim.x) {
            const int l = e & 31;
            int k = 0, rem = e >> 5;
            while (rem >= MT - (k >> 1)) {
                rem -= MT - (k >> 1);
                ++k;
            }
            const int ja = 16 * ((k >> 1) + rem) + (l >> 2), jb = ja + 8;
            const int i0 = 8 * k + (l & 3), i1 = i0 + 4;
            const float v[4] = {
                (ja < m && i0 < m) ? taps[ja * m + i0] : 0.f,
                (jb < m && i0 < m) ? taps[jb * m + i0] : 0.f,
                (ja < m && i1 < m) ? taps[ja * m + i1] : 0.f,
                (jb < m && i1 < m) ? taps[jb * m + i1] : 0.f};
            uint32_t h[4], lw[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                h[q] = tf32(v[q]);
                lw[q] = tf32(v[q] - __uint_as_float(h[q]));
            }
            hi[e] = make_uint4(h[0], h[1], h[2], h[3]);
            lo[e] = make_uint4(lw[0], lw[1], lw[2], lw[3]);
        }
    } else {
        float* tp = smem;
        for (int e = threadIdx.x; e < kMp * kPitch; e += blockDim.x) {
            const int j = e / kPitch, i = e - j * kPitch;
            tp[e] = (j < m && i < m) ? taps[j * m + i] : 0.f;
        }
    }
    float* us = smem + C::u;
    for (int e = threadIdx.x; e < 2 * kMp; e += blockDim.x) us[e] = (e < 2 * m) ? u[e] : 0.f;
    float* wst = smem + C::stage + warp * kStages * kTile;
    for (int e = lane; e < kStages * kTile; e += 32) wst[e] = 0.f;
    float* zs = smem + C::zs + warp * kRows * 2;
    __syncthreads();
    const long long t_pro = clk() - tp0;

    const float b0 = coeffs[0], b1 = coeffs[1], b2 = coeffs[2];
    const int chunks = s / m;
    const int groups = (tracks + kRows - 1) / kRows;
    const int gw = blockIdx.x * kWarps + warp;
    const int nw = gridDim.x * kWarps;
    const int items = (gw < groups) ? ((groups - 1 - gw) / nw + 1) * chunks : 0;
    const int q4 = m >> 2;
    const int r0 = q4 ? lane / q4 : 0, q0 = lane - r0 * q4;
    const int dr = q4 ? 32 / q4 : 0, dq = 32 - dr * q4;

    auto load = [&](int it) {
        const long long t0 = static_cast<long long>(gw + (it / chunks) * nw) * kRows;
        const int n0 = (it % chunks) * m;
        float* dst = wst + (it & 1) * kTile;
        if (vec) {
            for (int e = lane, r = r0, q = q0; e < kRows * q4;
                 e += 32, q += dq, r += dr + (q >= q4), q -= (q >= q4) ? q4 : 0) {
                const long long tr = t0 + r;
                const bool ok = tr < tracks;
                cp_async16(dst + r * kPitch + 4 * q, x + (ok ? tr * s + n0 + 4 * q : 0),
                           ok ? 16 : 0);
            }
        } else {
            for (int e = lane; e < kRows * m; e += 32) {
                const int r = e / m, q = e - r * m;
                const long long tr = t0 + r;
                const bool ok = tr < tracks;
                cp_async4(dst + r * kPitch + q, x + (ok ? tr * s + n0 + q : 0), ok ? 4 : 0);
            }
        }
    };

    if (!product_only && items > 0) load(0);
    cp_async_commit();
    float zn1 = 0.f, zn2 = 0.f;
    if (lane < kRows) {
        const long long tr = static_cast<long long>(gw) * kRows + lane;
        zn1 = (tr < tracks) ? z_in[2 * tr] : 0.f;
        zn2 = (tr < tracks) ? z_in[2 * tr + 1] : 0.f;
    }
    const int g = lane >> 2, t = lane & 3;
    for (int it = 0; it < items; ++it) {
        const long long c0 = clk();
        if (!product_only) {
            if (it + 1 < items) load(it + 1);
            cp_async_commit();
        }
        const long long ci = clk();
        t_issue += ci - c0;
        if (!product_only) cp_async_wait1();
        __syncwarp();
        const int c = it % chunks;
        const long long t0 = static_cast<long long>(gw + (it / chunks) * nw) * kRows;
        if (c == 0) {
            if (lane < kRows) {
                zs[2 * lane] = zn1;
                zs[2 * lane + 1] = zn2;
                const long long tr = t0 + static_cast<long long>(nw) * kRows + lane;
                zn1 = (tr < tracks) ? z_in[2 * tr] : 0.f;
                zn2 = (tr < tracks) ? z_in[2 * tr + 1] : 0.f;
            }
            __syncwarp();
        }
        const long long c1 = clk();
        t_wait += c1 - ci;
        float* xs = wst + (product_only ? 0 : (it & 1)) * kTile;
        if constexpr (MODE == 2) {
            constexpr int MT = NT / 2;
            float acc[MT][4];
            const uint4* hi = reinterpret_cast<const uint4*>(smem);
            bs_product<NT>(acc, xs, hi, hi + BsShape<NT>::steps() * 32, lane);
            const float z1a = zs[4 * t], z2a = zs[4 * t + 1];
            const float z1b = zs[4 * t + 2], z2b = zs[4 * t + 3];
            __syncwarp();
            float* pa = xs + (2 * t) * kPitch;
            float* pb = pa + kPitch;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int j = 16 * mt + g + 8 * h;
                    const float2 uu = *reinterpret_cast<const float2*>(us + 2 * j);
                    if (j < m) {
                        pa[j] = acc[mt][2 * h] + (uu.x * z1a + uu.y * z2a);
                        pb[j] = acc[mt][2 * h + 1] + (uu.x * z1b + uu.y * z2b);
                    }
                }
            }
        } else {
            float acc[NT][4];
            if constexpr (MODE == 1) {
                product_tc<NT>(acc, xs, reinterpret_cast<const uint4*>(smem), lane);
            } else {
                product_fma<NT>(acc, xs, smem, lane);
            }
            const float z1a = zs[2 * g], z2a = zs[2 * g + 1];
            const float z1b = zs[2 * g + 16], z2b = zs[2 * g + 17];
            __syncwarp();
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const int j = 8 * n + 2 * t;
                const float4 uu = *reinterpret_cast<const float4*>(us + 2 * j);
                const float wa0 = acc[n][0] + (uu.x * z1a + uu.y * z2a);
                const float wa1 = acc[n][1] + (uu.z * z1a + uu.w * z2a);
                const float wb0 = acc[n][2] + (uu.x * z1b + uu.y * z2b);
                const float wb1 = acc[n][3] + (uu.z * z1b + uu.w * z2b);
                float* pa = xs + g * kPitch + j;
                float* pb = pa + 8 * kPitch;
                if (j + 1 < m) {
                    *reinterpret_cast<float2*>(pa) = make_float2(wa0, wa1);
                    *reinterpret_cast<float2*>(pb) = make_float2(wb0, wb1);
                } else if (j < m) {
                    *pa = wa0;
                    *pb = wb0;
                }
            }
        }
        __syncwarp();
        const long long c2 = clk();
        t_prod += c2 - c1;
        if (product_only) continue;

        const int n0 = c * m;
        if (vec) {
            for (int e = lane, r = r0, q = q0; e < kRows * q4;
                 e += 32, q += dq, r += dr + (q >= q4), q -= (q >= q4) ? q4 : 0) {
                const int j = 4 * q;
                const long long tr = t0 + r;
                if (tr >= tracks) break;
                const float* w = xs + r * kPitch;
                const float4 wv = *reinterpret_cast<const float4*>(w + j);
                float p1, p2;
                if (j == 0) {
                    p1 = zs[2 * r];
                    p2 = zs[2 * r + 1];
                } else {
                    const float2 pv = *reinterpret_cast<const float2*>(w + j - 2);
                    p2 = pv.x;
                    p1 = pv.y;
                }
                float4 yv;
                yv.x = b0 * wv.x + b1 * p1 + b2 * p2;
                yv.y = b0 * wv.y + b1 * wv.x + b2 * p1;
                yv.z = b0 * wv.z + b1 * wv.y + b2 * wv.x;
                yv.w = b0 * wv.w + b1 * wv.z + b2 * wv.y;
                *reinterpret_cast<float4*>(y + tr * s + n0 + j) = yv;
            }
        } else {
            for (int e = lane; e < kRows * m; e += 32) {
                const int r = e / m, j = e - r * m;
                const long long tr = t0 + r;
                if (tr >= tracks) break;
                const float* w = xs + r * kPitch;
                const float wm1 = (j >= 1) ? w[j - 1] : zs[2 * r];
                const float wm2 = (j >= 2) ? w[j - 2] : (j == 1 ? zs[2 * r] : zs[2 * r + 1]);
                y[tr * s + n0 + j] = b0 * w[j] + b1 * wm1 + b2 * wm2;
            }
        }
        __syncwarp();
        const long long c3 = clk();
        t_y += c3 - c2;
        if (lane < kRows) {
            const float* w = xs + lane * kPitch;
            zs[2 * lane] = w[m - 1];
            zs[2 * lane + 1] = w[m - 2];
            const long long tr = t0 + lane;
            if (c == chunks - 1 && tr < tracks) {
                z_out[2 * tr] = zs[2 * lane];
                z_out[2 * tr + 1] = zs[2 * lane + 1];
            }
        }
        __syncwarp();
        t_tail += clk() - c3;
    }
    if (prof && lane == 0) {
        long long* p = prof + (static_cast<long long>(blockIdx.x) * kWarps + warp) * 8;
        p[0] = t_pro;
        p[1] = t_issue;
        p[2] = t_wait;
        p[3] = t_prod;
        p[4] = t_y;
        p[5] = t_tail;
        p[6] = clk() - tp0;
        p[7] = items;
    }
}

template <int NT, int MODE>
cudaError_t launch(const float* x, const float* coeffs, const float* taps,
                   const float* u, const float* z_in, float* y, float* z_out,
                   int tracks, int s, int m, cudaStream_t st, int product_only,
                   long long* prof, int* grid_out) {
    using C = Cfg<NT, MODE>;
    const int bytes = C::total * static_cast<int>(sizeof(float));
    cudaError_t err = cudaFuncSetAttribute(
        stage_kernel<NT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
        return err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stage_kernel<NT, MODE>,
                                                        C::kThreads, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int groups = (tracks + C::kRows - 1) / C::kRows;
    const int blocks = std::min(sms * per_sm, (groups + C::kWarps - 1) / C::kWarps);
    const int vec = (m % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(y) % 16 == 0);
    if (grid_out) *grid_out = blocks;
    stage_kernel<NT, MODE><<<blocks, C::kThreads, bytes, st>>>(
        x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, vec, product_only, prof);
    return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(const float* x, const float* coeffs, const float* taps,
                     const float* u, const float* z_in, float* y, float* z_out,
                     int tracks, int s, int m, cudaStream_t st, int product_only,
                     long long* prof, int* grid_out) {
    const int nt = (m + 7) / 8;
#define STAGE(N) launch<N, MODE>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st, \
                                 product_only, prof, grid_out)
    if constexpr (MODE != 2) {
        if (nt <= 1) return STAGE(1);
    }
    if (nt <= 2) return STAGE(2);
    if (nt <= 4) return STAGE(4);
    if (nt <= 8) return STAGE(8);
    return STAGE(16);
#undef STAGE
}

}  // namespace stages

extern "C" {

// The blockstate kernel as it was: same arguments as iir_blockstate_launch.
int old_blockstate_launch(const float* x, const float* coeffs, const float* taps,
                          const float* u, const float* z_in, float* y, float* z_out,
                          int tracks, int s, int m, void* stream) {
    if (tracks <= 0 || s <= 0 || m < 2 || m > 128 || s % m != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int rows = (m + old_form::kBsWarps - 1) / old_form::kBsWarps;
    cudaError_t err;
    if (rows <= 1) {
        err = old_form::launch_blockstate<1>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    } else if (rows <= 2) {
        err = old_form::launch_blockstate<2>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    } else if (rows <= 4) {
        err = old_form::launch_blockstate<4>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    } else if (rows <= 8) {
        err = old_form::launch_blockstate<8>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    } else {
        err = old_form::launch_blockstate<16>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    }
    return static_cast<int>(err);
}

// The old kernel at m = 128 with clock64() phase sums: prof holds 8 int64
// for each of the (tracks / 32) x 8 warps.
int old_blockstate_profile(const float* x, const float* coeffs, const float* taps,
                           const float* u, const float* z_in, float* y, float* z_out,
                           int tracks, int s, long long* prof, void* stream) {
    if (tracks <= 0 || s <= 0 || s % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(old_form::launch_profiled(x, coeffs, taps, u, z_in, y, z_out,
                                                      tracks, s, prof,
                                                      static_cast<cudaStream_t>(stream)));
}

// Blocks an SM of the old kernel at m = 128, and its dynamic shared memory.
int old_blockstate_occupancy(int* bytes_out) {
    const int bytes = old_form::BsLayout(128, 16).total * static_cast<int>(sizeof(float));
    cudaFuncSetAttribute(old_form::iir_blockstate_kernel<16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, old_form::iir_blockstate_kernel<16>, old_form::kBsThreads, bytes);
    *bytes_out = bytes;
    return per_sm;
}

// Blocks an SM of the shipped kernel at m = 128, and its shared memory.
int shipped_blockstate_occupancy(int* bytes_out) {
    const int bytes = BsShape<16>::kTotal * static_cast<int>(sizeof(float));
    cudaFuncSetAttribute(iir_blockstate_kernel<16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, iir_blockstate_kernel<16>,
                                                  kBsThreads, bytes);
    *bytes_out = bytes;
    return per_sm;
}

// variant 1: stage A; 2: stage B's first form; 3: the shipped kernel,
// instrumented. prof: 8 int64 per warp (or null); grid_out: blocks.
int stage_launch(const float* x, const float* coeffs, const float* taps,
                 const float* u, const float* z_in, float* y, float* z_out,
                 int tracks, int s, int m, int variant, int product_only,
                 long long* prof, int* grid_out, void* stream) {
    if (tracks <= 0 || s <= 0 || m < 2 || m > 128 || s % m != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (variant == 1) {
        err = stages::dispatch<0>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st,
                                  product_only, prof, grid_out);
    } else if (variant == 2) {
        err = stages::dispatch<1>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st,
                                  product_only, prof, grid_out);
    } else {
        err = stages::dispatch<2>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st,
                                  product_only, prof, grid_out);
    }
    return static_cast<int>(err);
}

int hmma_probe(float* out, int blocks, int threads, int iters, void* stream) {
    stages::hmma_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        out, iters);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
