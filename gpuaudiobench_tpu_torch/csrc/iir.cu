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
// * iir_cascade_chain_kernel<K, kTma, kRing, kConst> replaces
//   _iir_cascade_kernel (ops/iir.py:130, via iir_cascade_pallas_chain):
//   each sample runs through all K stages before the next starts, 2K
//   states in registers. It is the systolic kernel's oracle (BiquadChain
//   holds one against the other), so it shares none of that kernel's
//   device code or its skewed schedule. Bound: the biquad's bytes plus 5K
//   FP32 instructions a sample (at 65,536 x 512, K = 10, 268 MB against
//   ~50 us of issue), so bytes first. What the design does about it
//   (PERF.md §6 has the measurements):
//   - the coefficients live in the constant bank (c_chain_coeffs, filled
//     by a copy on the stream before each launch), so the FFMAs read
//     them as operands and a thread holds only its 2K states: 65,536
//     tracks are one wave of 4 blocks of 4 warps an SM;
//   - a warp owns 32 tracks and a ring of kRing chunk tiles (32 tracks x
//     32 samples, 128-byte rows, the TMA's 128-byte swizzle), filled by
//     TMA loads that one lane issues onto an mbarrier a tile and written
//     back by TMA stores from the same tile, so the next chunks' copies
//     run under this chunk's samples and nothing waits on another warp;
//   - a lane walks its row four samples at a time (one conflict-free
//     16-byte shared access a quad: the swizzle puts the 8 rows of a
//     quarter-warp on 8 different 16-byte pieces), the loop unrolled by
//     the quad, so the states advance by register renaming;
//   - where TMA cannot take the rows (S % 4 != 0, or x or y not 16-byte
//     aligned) the host picks the staged route (kTma false): the same
//     tile and sample loop, the tile filled and stored element by
//     element by the warp's lanes.
//   What holds it now is the tile pattern, not the arithmetic: its TMA
//   copies alone, with no stages, take ~87 % of its time, against ~76 %
//   for a plain copy of the same bytes (PERF.md §6, tools/cascade_stages).
// * iir_cascade_systolic_kernel<K, ...> replaces _iir_cascade_kernel_systolic
//   (ops/iir.py:161, via iir_cascade_pallas). At step t stage k works on
//   sample t - k, so the K stage updates of a step are independent: one
//   thread holds the skewed K-stage plane in registers, which turns the
//   chain's K-long dependency into K-wide instruction-level parallelism.
//   Bound of both cascades: the same bytes as the biquad plus 5K
//   instructions per sample (10 stages: 50, about 50 us of issue at
//   65,536 x 512), so still bytes first. What the design does about it
//   (PERF.md §6 has the measurements that chose it):
//   - a warp owns 32 tracks and moves its own 32-sample chunk tiles
//     through a ring of cp.async copies (16 bytes a lane where s % 4 == 0),
//     so the next chunks load under this chunk's steps; the sample loop
//     waits only on its own copies and warp syncs, never on the block;
//   - a lane reads its row four samples at a time and writes four outputs
//     at a time (16-byte shared accesses on a 36-float pitch, free of bank
//     conflicts); the outputs overwrite their own inputs in the tile,
//     aligned to output samples, so the K - 1 lag costs nothing and each
//     row is stored along samples in whole 16-byte pieces;
//   - the live mask (0 <= t - k < S) runs only in the K - 1 warm-up steps
//     and the drain; the steady steps, 4 to a quad so the carried values
//     advance by renaming, have none;
//   - the schedule (grid, step ranges, chunks) is computed on the host
//     (ops/iir.py cascade_schedule) and checked here; at 65,536 tracks its
//     2,048 warps are one wave at 16 warps an SM.
//   Each (sample, stage) update is the chain kernel's expression on the
//   same operands, so its outputs and states are bit for bit those of the
//   one-thread-a-track kernel it replaced (tools/cascade_stages).
//   The two cascades share no device function: only the host's grid_for
//   and the C entry points' argument checks.
// * iir_blockstate_kernel<NT> replaces _iir_blockstate_kernel
//   (ops/iir.py:407, via iir_biquad_blockstate_pallas). Each m-sample
//   chunk is w = taps @ x_chunk + u0*z1 + u1*z2, then
//   y = b0*w + b1*w[-1] + b2*w[-2], and (z1, z2) = (w[m-1], w[m-2]).
//   The chunk products do not depend on each other; only the rank-2 term
//   carries from chunk to chunk. Bound: bytes (at 65,536 x 512, m = 128,
//   268 MB, 80 us at 3.35 TB/s; the triangular product is 138 FLOP a
//   sample, 69 us at 67 TFLOP/s in FP32). The JAX kernel runs the product
//   at Precision.HIGHEST and its tests hold it to 1e-5 of the scan, which
//   plain TF32 misses, so the product runs in 3xTF32 on the tensor cores
//   (mma.sync m16n8k8): v = hi + lo with hi = tf32(v) and lo = tf32(v -
//   hi) (cvt.rna), and A_lo B_hi + A_hi B_lo + A_hi B_hi go into a fresh
//   zero accumulator per 8-sample k-step, which is added into FP32
//   registers by IEEE adds: the tensor cores never sum across k-steps
//   (their FP32 sums are coarser than IEEE, ROADMAP's SOL_MXU_bf16 fault).
//   The taps are the A operand (16 rows of w by 8 samples), a warp's 8
//   tracks the B operand; k-tiles above the diagonal are skipped, 72 of
//   128 steps remain at m = 128. What the design does about what held the
//   earlier one-block-per-32-tracks kernel at 16 % of its bound:
//   - every warp owns 8 tracks and runs the whole triangle for them, so
//     all warps do equal work and no block barrier waits on the slowest;
//   - the grid is persistent (one block of 16 warps an SM at m > 64, from
//     the occupancy API): a block splits the taps into hi/lo fragments
//     once, in the order the mmas read them (one conflict-free 16-byte
//     read per lane a step), instead of 2,048 blocks re-reading and
//     transposing 64 KiB each;
//   - each warp walks its (track group, chunk) items with a 2-stage ring
//     of cp.async copies (16 bytes a lane), so the next chunk's load runs
//     under this chunk's product; the loop has no block barrier at all,
//     only warp syncs;
//   - the product reads one 16-byte fragment pair per three mmas, not
//     five shared loads per 16 FMAs.
//   w goes back into the warp's stage, y is written from it along
//   samples (16 bytes a lane), and the state is carried in shared memory.
//   m is padded with zeros to 16, 32, 64 or 128 in shared memory, so one
//   kernel serves every m from 2 to 128; m not a multiple of 4 (or
//   unaligned rows) copies 4 bytes a lane. What bounds it now is the
//   product's mma.sync latency chain, not the bytes: the product alone,
//   with no copies, takes about two thirds of the kernel's time (PERF.md
//   §6, tools/blockstate_stages).
//
// Rounding: nvcc contracts the recurrences into FMAs, which round unlike
// the NumPy golden's separate f32 steps. The models' tolerances (1e-4 on
// the output, 1e-3 on the state) leave room; kernel-vs-twin agreement is
// checked at 1e-5 absolute (tests/test_torch_cuda.py, chip_smoke.py).
//
// Every launch goes on the caller's stream, writes only the outputs the
// wrapper allocated (never the input state), and returns
// cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its encoder's types (reached at run time)
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kTracks = 128;   // tracks (= threads) per block, tile kernels
constexpr int kChunk = 32;     // samples per shared-memory tile
constexpr int kPitch = kChunk + 1;
constexpr int kMaxStages = 16;

constexpr int kBsWarps = 16;   // blockstate: warps per block
constexpr int kBsThreads = kBsWarps * 32;
constexpr int kBsRows = 8;     // blockstate: tracks per warp (the mma's N)
constexpr int kBsStages = 2;   // blockstate: x chunks in flight per warp

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
// are in flight per thread (the biquad takes all kChunk at once; the old
// cascade kernels of tools/cascade_stages, which hold their stages in
// registers, 8).
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

// The chain cascade. A warp owns 32 tracks, one a lane, and walks their
// samples through a ring of kRing chunk tiles of its own in shared memory
// (one tile on the staged route): nothing in the sample loop waits on
// another warp. A tile is 32 rows (tracks) of 32 samples, 128 bytes a
// row, laid out as the TMA's 128-byte swizzle writes it: the 16-byte
// piece q (samples 4q .. 4q + 3) of row r sits at piece q ^ (r % 8) of the
// row. A lane reads and writes its row a piece at a time, and the 8 lanes
// of each quarter-warp then touch 8 different pieces: all 32 banks once.
// Chunk c lives in slot c % kRing, and its outputs overwrite its inputs
// in the slot, from which the TMA store writes them back.
constexpr int kChWarps = 4;                    // warps per block
constexpr int kChRing = 3;                     // chunk tiles per warp (TMA route)
constexpr int kChTile = 32 * 32;               // floats a tile
constexpr int kChTileBytes = kChTile * static_cast<int>(sizeof(float));
constexpr int kChAlign = 1024;                 // the 128-byte swizzle's tile alignment

// b0, b1, b2, a1, a2 of stage k at 5k. One copy for every launch: a launch
// copies its coefficients here on its stream first, so two launches on
// different streams with different coefficients would race on it.
__constant__ float c_chain_coeffs[kMaxStages * 5];

#ifndef CHAIN_MARK
// CHAIN_MARK(q) ends phase q of a warp's time (0 the start, 7 the end);
// tools/cascade_stages builds it into clock64() phase sums, the port
// into nothing.
#define CHAIN_MARK(q)
#endif

__device__ __forceinline__ uint32_t ch_smem(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Offset (floats) of sample j of row r in a swizzled tile.
__device__ __forceinline__ int ch_swizzle(int r, int j) {
    return 32 * r + ((((j >> 2) ^ r) & 7) << 2) + (j & 3);
}

// Waits until the phase of the given parity of *bar has completed.
__device__ __forceinline__ void ch_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(ch_smem(bar)), "r"(parity) : "memory");
    } while (!done);
}

// The (32 tracks x 32 samples) box of the map at (sample n0, track t0)
// into tile, completing on bar (zeros past the edges of x).
__device__ __forceinline__ void ch_tma_load(float* tile, const CUtensorMap* map,
                                            uint64_t* bar, int n0, int t0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(ch_smem(bar)), "r"(kChTileBytes) : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(ch_smem(tile)), "l"(reinterpret_cast<uint64_t>(map)), "r"(ch_smem(bar)),
           "r"(n0), "r"(t0)
        : "memory");
}

// tile into the map's box at (n0, t0), clipped at the edges of y; one
// bulk group.
__device__ __forceinline__ void ch_tma_store(const CUtensorMap* map, const float* tile,
                                             int n0, int t0) {
    asm volatile(
        "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(ch_smem(tile)), "r"(n0), "r"(t0)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The staged route's fill: row r of the tile from track t0 + r, sample
// n0 + lane by each lane (zeros past the edges), 8 loads in flight a lane.
__device__ __forceinline__ void ch_fill(float* tile, const float* __restrict__ x,
                                        long long t0, int rows, int s, int n0, int len,
                                        int lane) {
    const bool in = lane < len;
#pragma unroll 1
    for (int r0 = 0; r0 < 32; r0 += 8) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int r = r0 + i;
            v[i] = (in && r < rows) ? x[(t0 + r) * s + n0 + lane] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) tile[ch_swizzle(r0 + i, lane)] = v[i];
    }
}

// The staged route's store, the fill's mirror.
__device__ __forceinline__ void ch_drain(float* __restrict__ y, const float* tile,
                                         long long t0, int rows, int s, int n0, int len,
                                         int lane) {
    if (lane >= len) return;
#pragma unroll 4
    for (int r = 0; r < rows; ++r) y[(t0 + r) * s + n0 + lane] = tile[ch_swizzle(r, lane)];
}

// The K stages' coefficients: read from the constant bank as the FFMAs'
// operands (kConst), or held in registers, loaded from coeffs.
template <int K, bool kConst>
struct ChCoeffs {
    float r[kConst ? 1 : 5 * K];
    __device__ __forceinline__ void from_global(const float* __restrict__ coeffs) {
        if constexpr (!kConst) {
#pragma unroll
            for (int i = 0; i < 5 * K; ++i) r[i] = coeffs[i];
        }
    }
    __device__ __forceinline__ float operator[](int i) const {
        if constexpr (kConst) {
            return c_chain_coeffs[i];
        } else {
            return r[i];
        }
    }
};

// Samples v[0 .. N - 1] of the lane's track through the K stages, each
// sample through every stage before the next: the per-sample chain.
// Each update is
//     w = v - a1*z1 - a2*z2,   v = b0*w + b1*z1 + b2*z2,
// with its roundings written out as nvcc contracted that expression in
// the kernel this one replaced (tools/cascade_stages checks it bit for
// bit at every depth): w = fma(-a2, z2, fma(-a1, z1, v)), and v =
// fma(b2, z2, fma(b0, w, b1*z1)), but fma(b2, z2, fma(b1, z1, b0*w)) at
// K = 1. The compiler picks either product of b0*w + b1*z1 to round
// alone by what surrounds it, so the oracle fixes its choice.
template <int K, bool kConst, int N>
__device__ __forceinline__ void ch_samples(float (&v)[4], float (&z1)[K], float (&z2)[K],
                                           const ChCoeffs<K, kConst>& cf) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const float b0 = cf[5 * k], b1 = cf[5 * k + 1], b2 = cf[5 * k + 2];
            const float a1 = cf[5 * k + 3], a2 = cf[5 * k + 4];
            const float w = __fmaf_rn(-a2, z2[k], __fmaf_rn(-a1, z1[k], v[i]));
            const float p = K == 1 ? __fmaf_rn(b1, z1[k], __fmul_rn(b0, w))
                                   : __fmaf_rn(b0, w, __fmul_rn(b1, z1[k]));
            v[i] = __fmaf_rn(b2, z2[k], p);
            z2[k] = z1[k];
            z1[k] = w;
        }
    }
}

// kTma: the TMA route (x_map, y_map; S % 4 == 0), else the staged route
// (x, y). kRing: chunk tiles a warp on the TMA route. kConst: the
// coefficients from the constant bank, else from coeffs into registers
// (tools/cascade_stages' variant).
template <int K, bool kTma, int kRing, bool kConst>
__global__ void __launch_bounds__(kChWarps * 32, 4)
iir_cascade_chain_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap y_map,
                         const float* __restrict__ x, const float* __restrict__ coeffs,
                         const float* __restrict__ z_in, float* __restrict__ y,
                         float* __restrict__ z_out, int tracks, int s, int chunks) {
    constexpr int R = kTma ? kRing : 1;
    // The slot chunk c - kLag held is refilled after chunk c's store: one
    // chunk later than its own store with 3 or more tiles, so the issuing
    // lane never waits on the store just issued.
    constexpr int kLag = R >= 3 ? 1 : 0;
    extern __shared__ float4 ch_smem4[];
    __shared__ uint64_t full[kChWarps][R];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long t0 = (static_cast<long long>(blockIdx.x) * kChWarps + warp) * 32;
    if (t0 >= tracks) return;
    const int rows = static_cast<int>(min(32LL, tracks - t0));
    const uint32_t raw = ch_smem(ch_smem4);
    float* ring = reinterpret_cast<float*>(
                      reinterpret_cast<char*>(ch_smem4) +
                      (((raw + kChAlign - 1) & ~static_cast<uint32_t>(kChAlign - 1)) - raw)) +
                  warp * R * kChTile;
    uint64_t* bar = full[warp];
    CHAIN_MARK(0);

    if (kTma && lane == 0) {  // one lane a warp issues its copies
#pragma unroll
        for (int r = 0; r < R; ++r) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(ch_smem(&bar[r]))
                         : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
        for (int c = 0; c < R; ++c) {
            if (c < chunks) ch_tma_load(ring + c * kChTile, &x_map, &bar[c], 32 * c,
                                        static_cast<int>(t0));
        }
    }
    __syncwarp();

    ChCoeffs<K, kConst> cf;
    cf.from_global(coeffs);
    const long long t = t0 + lane;
    const bool live = lane < rows;
    float z1[K], z2[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const long long e = static_cast<long long>(k) * tracks + t;
        z1[k] = live ? z_in[2 * e] : 0.f;
        z2[k] = live ? z_in[2 * e + 1] : 0.f;
    }
    const int sw = lane & 7;
    CHAIN_MARK(1);

    for (int c = 0; c < chunks; ++c) {
        float* tile = ring + (c % R) * kChTile;
        const int n0 = 32 * c;
        const int len = min(32, s - n0);
        if constexpr (kTma) {
            ch_wait(&bar[c % R], (c / R) & 1);
        } else {
            ch_fill(tile, x, t0, rows, s, n0, len, lane);
            __syncwarp();
        }
        CHAIN_MARK(2);
        float* row = tile + 32 * lane;
        const int quads = len >> 2;
#pragma unroll 1
        for (int q = 0; q < quads; ++q) {
            float4* p = reinterpret_cast<float4*>(row + ((q ^ sw) << 2));
            const float4 in = *p;
            float v[4] = {in.x, in.y, in.z, in.w};
            ch_samples<K, kConst, 4>(v, z1, z2, cf);
            *p = make_float4(v[0], v[1], v[2], v[3]);
        }
        if constexpr (!kTma) {  // a chunk's last len % 4 samples (S % 4 != 0)
            for (int j = 4 * quads; j < len; ++j) {
                float* p = tile + ch_swizzle(lane, j);
                float v[4] = {*p, 0.f, 0.f, 0.f};
                ch_samples<K, kConst, 1>(v, z1, z2, cf);
                *p = v[0];
            }
        }
        CHAIN_MARK(3);
        if constexpr (kTma) {
            // The lanes' outputs are in the tile: order them before the
            // async proxy's read, then one lane stores the chunk and
            // refills the slot whose store has been read out.
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            __syncwarp();
            if (lane == 0) {
                ch_tma_store(&y_map, tile, n0, static_cast<int>(t0));
                const int old = c - kLag;
                if (old >= 0 && old + R < chunks) {
                    asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(kLag) : "memory");
                    ch_tma_load(ring + (old % R) * kChTile, &x_map, &bar[old % R],
                                32 * (old + R), static_cast<int>(t0));
                }
            }
        } else {
            __syncwarp();
            ch_drain(y, tile, t0, rows, s, n0, len, lane);
            __syncwarp();  // the tile is read out: it takes the next chunk
        }
        CHAIN_MARK(4);
    }

    if (live) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const long long e = static_cast<long long>(k) * tracks + t;
            z_out[2 * e] = z1[k];
            z_out[2 * e + 1] = z2[k];
        }
    }
    // The stores must have read the tiles before the block's shared
    // memory goes.
    if (kTma && lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    CHAIN_MARK(7);
}

// The blockstate kernel. A warp owns kBsRows tracks and walks their
// m-sample chunks in order; the grid is persistent, so a block builds the
// taps' fragment table once and its warps share it. All offsets below are
// in floats, for NT = ceil(m / 8) k-tiles of 8 samples (2, 4, 8 or 16).
template <int NT>
struct BsShape {
    static constexpr int kMt = NT / 2;             // m-tiles of 16 rows of w
    static constexpr int kPitch = 8 * NT + 4;      // one track's chunk
    static constexpr int kTile = kBsRows * kPitch; // a warp's stage
    // (k-tile, m-tile) steps below the diagonal, k outer: m-tile mt needs
    // k-tiles 0 .. 2mt + 1.
    __host__ __device__ static constexpr int steps() {
        int n = 0;
        for (int k = 0; k < NT; ++k) n += kMt - (k >> 1);
        return n;
    }
    static constexpr int kHi = 0;                   // uint4 per (step, lane)
    static constexpr int kLo = kHi + steps() * 32 * 4;
    static constexpr int kU = kLo + steps() * 32 * 4;  // u[j][2], zero past m
    static constexpr int kStage = kU + 16 * NT;
    static constexpr int kZ = kStage + kBsWarps * kBsStages * kTile;  // (z1, z2)
    static constexpr int kTotal = kZ + kBsWarps * kBsRows * 2;
};

// TF32 of v, rounded to nearest with ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
    return r;
}

// d += a (16 x 8, row) @ b (8 x 8, col), TF32 in, FP32 out.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Asynchronous copies into shared memory; bytes = 0 fills zeros.
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

// acc[mt] = the 16 x 8 tile (rows j = 16mt + g, 16mt + g + 8; tracks 2t,
// 2t + 1) of taps @ x_chunk^T, g = lane / 4, t = lane % 4. Each step is
// one k-tile of one m-tile in 3xTF32: small terms first, the three mmas
// into a fresh zero accumulator, which is then added into acc in FP32.
// The next step's taps fragments are read one step ahead, and a step's
// sum is added into acc one step late, so the adds never wait on the
// mmas just issued.
template <int NT>
__device__ __forceinline__ void bs_product(float (&acc)[NT / 2][4], const float* xs,
                                           const uint4* hi, const uint4* lo, int lane) {
    using B = BsShape<NT>;
    constexpr int kSteps = B::steps();
    const float* rx = xs + (lane >> 2) * B::kPitch + (lane & 3);
#pragma unroll
    for (int mt = 0; mt < B::kMt; ++mt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][q] = 0.f;
    }
    uint4 hn = hi[lane], ln = lo[lane];
    float dp[4] = {0.f, 0.f, 0.f, 0.f};
    int mp = 0;
    int st = 0;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float v = rx[8 * k + 4 * h];
            bh[h] = tf32_rna(v);
            bl[h] = tf32_rna(v - __uint_as_float(bh[h]));
        }
#pragma unroll
        for (int mt = k >> 1; mt < B::kMt; ++mt) {
            const uint4 hc = hn, lc = ln;
            if (st + 1 < kSteps) {
                hn = hi[(st + 1) * 32 + lane];
                ln = lo[(st + 1) * 32 + lane];
            }
            const uint32_t ah[4] = {hc.x, hc.y, hc.z, hc.w};
            const uint32_t al[4] = {lc.x, lc.y, lc.z, lc.w};
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(d, al, bh[0], bh[1]);
            mma_tf32(d, ah, bl[0], bl[1]);
            mma_tf32(d, ah, bh[0], bh[1]);
            if (st > 0) {
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[mp][q] += dp[q];
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) dp[q] = d[q];
            mp = mt;
            ++st;
        }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[mp][q] += dp[q];
}

template <int NT>
__global__ void __launch_bounds__(kBsThreads, 1)
iir_blockstate_kernel(const float* __restrict__ x,
                      const float* __restrict__ coeffs,
                      const float* __restrict__ taps,
                      const float* __restrict__ u,
                      const float* __restrict__ z_in, float* __restrict__ y,
                      float* __restrict__ z_out, int tracks, int s, int m,
                      int vec) {
    using B = BsShape<NT>;
    constexpr int kPitch = B::kPitch;
    constexpr int kSteps = B::steps();
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    uint4* hi = reinterpret_cast<uint4*>(smem + B::kHi);
    uint4* lo = reinterpret_cast<uint4*>(smem + B::kLo);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;

    // The taps in A-fragment order, split once: entry (step, lane) holds
    // a0..a3 = taps[16mt + g (+8)][8k + t (+4)], zero outside m x m.
    for (int e = threadIdx.x; e < kSteps * 32; e += kBsThreads) {
        const int l = e & 31;
        int k = 0, rem = e >> 5;
        while (rem >= B::kMt - (k >> 1)) {
            rem -= B::kMt - (k >> 1);
            ++k;
        }
        const int ja = 16 * ((k >> 1) + rem) + (l >> 2), jb = ja + 8;
        const int i0 = 8 * k + (l & 3), i1 = i0 + 4;
        const float v[4] = {
            (ja < m && i0 < m) ? taps[ja * m + i0] : 0.f,
            (jb < m && i0 < m) ? taps[jb * m + i0] : 0.f,
            (ja < m && i1 < m) ? taps[ja * m + i1] : 0.f,
            (jb < m && i1 < m) ? taps[jb * m + i1] : 0.f};
        uint32_t h[4], r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            h[q] = tf32_rna(v[q]);
            r[q] = tf32_rna(v[q] - __uint_as_float(h[q]));
        }
        hi[e] = make_uint4(h[0], h[1], h[2], h[3]);
        lo[e] = make_uint4(r[0], r[1], r[2], r[3]);
    }
    float* us = smem + B::kU;
    for (int e = threadIdx.x; e < 16 * NT; e += kBsThreads) us[e] = (e < 2 * m) ? u[e] : 0.f;
    // Zeros in the stages: the columns past m stay zero for good.
    float* wst = smem + B::kStage + warp * kBsStages * B::kTile;
    for (int e = lane; e < kBsStages * B::kTile; e += 32) wst[e] = 0.f;
    float* zs = smem + B::kZ + warp * kBsRows * 2;
    __syncthreads();  // the only block-wide barrier

    const float b0 = coeffs[0], b1 = coeffs[1], b2 = coeffs[2];
    const int chunks = s / m;
    const int groups = (tracks + kBsRows - 1) / kBsRows;
    const int gw = blockIdx.x * kBsWarps + warp;
    const int nw = gridDim.x * kBsWarps;
    // Item it is chunk it % chunks of track group gw + (it / chunks) * nw.
    const int items = (gw < groups) ? ((groups - 1 - gw) / nw + 1) * chunks : 0;
    const int q4 = m >> 2;
    // Lane's first (row, 16-byte column) of a stage, and the step per 32.
    const int r0 = q4 ? lane / q4 : 0, q0 = lane - r0 * q4;
    const int dr = q4 ? 32 / q4 : 0, dq = 32 - dr * q4;

    auto load = [&](int it) {  // item it's x chunk into stage it % 2
        const long long t0 = static_cast<long long>(gw + (it / chunks) * nw) * kBsRows;
        const int n0 = (it % chunks) * m;
        float* dst = wst + (it & 1) * B::kTile;
        if (vec) {
            for (int e = lane, r = r0, q = q0; e < kBsRows * q4;
                 e += 32, q += dq, r += dr + (q >= q4), q -= (q >= q4) ? q4 : 0) {
                const long long tr = t0 + r;
                const bool ok = tr < tracks;
                cp_async16(dst + r * kPitch + 4 * q, x + (ok ? tr * s + n0 + 4 * q : 0),
                           ok ? 16 : 0);
            }
        } else {
            for (int e = lane; e < kBsRows * m; e += 32) {
                const int r = e / m, q = e - r * m;
                const long long tr = t0 + r;
                const bool ok = tr < tracks;
                cp_async4(dst + r * kPitch + q, x + (ok ? tr * s + n0 + q : 0), ok ? 4 : 0);
            }
        }
    };

    if (items > 0) load(0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    // The entering state of the warp's next group, read one group ahead.
    float zn1 = 0.f, zn2 = 0.f;
    if (lane < kBsRows) {
        const long long tr = static_cast<long long>(gw) * kBsRows + lane;
        zn1 = (tr < tracks) ? z_in[2 * tr] : 0.f;
        zn2 = (tr < tracks) ? z_in[2 * tr + 1] : 0.f;
    }
    const int g = lane >> 2, t = lane & 3;
    for (int it = 0; it < items; ++it) {
        if (it + 1 < items) load(it + 1);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // item it is in
        __syncwarp();
        const int c = it % chunks;
        const long long t0 = static_cast<long long>(gw + (it / chunks) * nw) * kBsRows;
        if (c == 0) {
            if (lane < kBsRows) {
                zs[2 * lane] = zn1;
                zs[2 * lane + 1] = zn2;
                const long long tr = t0 + static_cast<long long>(nw) * kBsRows + lane;
                zn1 = (tr < tracks) ? z_in[2 * tr] : 0.f;
                zn2 = (tr < tracks) ? z_in[2 * tr + 1] : 0.f;
            }
            __syncwarp();
        }
        float* xs = wst + (it & 1) * B::kTile;
        float acc[B::kMt][4];
        bs_product<NT>(acc, xs, hi, lo, lane);
        const float z1a = zs[4 * t], z2a = zs[4 * t + 1];
        const float z1b = zs[4 * t + 2], z2b = zs[4 * t + 3];
        __syncwarp();  // every x read is done: the stage now takes w
        float* pa = xs + (2 * t) * kPitch;
        float* pb = pa + kPitch;
#pragma unroll
        for (int mt = 0; mt < B::kMt; ++mt) {
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
        __syncwarp();

        // y[t, n0 + j] from w[j], w[j-1], w[j-2] (the entering state for
        // j < 2), written along samples.
        const int n0 = c * m;
        if (vec) {
            for (int e = lane, r = r0, q = q0; e < kBsRows * q4;
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
            for (int e = lane; e < kBsRows * m; e += 32) {
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
        if (lane < kBsRows) {
            const float* w = xs + lane * kPitch;
            zs[2 * lane] = w[m - 1];
            zs[2 * lane + 1] = w[m - 2];
            const long long tr = t0 + lane;
            if (c == chunks - 1 && tr < tracks) {
                z_out[2 * tr] = zs[2 * lane];
                z_out[2 * tr + 1] = zs[2 * lane + 1];
            }
        }
        __syncwarp();  // the stage is free for the copy two items on
    }
}

// The systolic cascade. A warp owns 32 tracks, one a lane, and walks
// their samples through a ring of kR 32-sample chunk tiles of its own in
// shared memory: nothing in the sample loop waits on another warp. Row
// pitch kCsPitch: 16-byte rows, so a lane reads its row four samples at a
// time (LDS.128), and each 8-lane phase of such a read touches the 32
// banks once. Chunk c lives in slot c % kR. Output sample n is written
// back into the slot of input chunk n / 32, over its input, which step n
// read K - 1 steps before; so output chunk o is complete once the quads
// that emit samples 32o .. 32o + 31 have run, is stored from its slot
// along samples, and the slot then takes the copy of chunk o + kR.
constexpr int kCsWarps = 4;    // warps per block
constexpr int kCsRing = 3;     // chunk tiles per warp: two read, one in flight
constexpr int kCsUnroll = 1;   // steady quads per loop pass
constexpr int kCsPitch = 36;   // floats per tile row
constexpr int kCsTile = 32 * kCsPitch;

// Warps an SM each depth is built to keep resident: 16 (the full shape's
// 2,048 warps in one wave) while the K stages' 5K coefficients and 3K
// carried values fit 128 registers, fewer above, so that no depth spills.
template <int K>
struct CsDepth {
    static constexpr int kMinWarps = K <= 10 ? 16 : (K <= 13 ? 12 : 8);
};

#ifndef CASCADE_MARK
// CASCADE_MARK(q) ends phase q of a warp's time (0 the start, 7 the end);
// tools/cascade_stages builds it into clock64() phase sums, the port
// into nothing.
#define CASCADE_MARK(q)
#endif

// One step of the skewed plane: stage k takes sample t - k, last stage
// first, so yl[k - 1] is still stage k - 1's output of the step before.
// With kMask a stage whose sample lies outside [0, s) keeps its state
// (warm-up and drain); in a steady step every stage is live. Each update
// is the chain kernel's expression on the same operands.
template <int K, bool kMask>
__device__ __forceinline__ void cascade_step(const Coeffs (&c)[K], float (&z1)[K],
                                             float (&z2)[K], float (&yl)[K],
                                             float xin, int t, int s) {
#pragma unroll
    for (int k = K - 1; k >= 0; --k) {
        const float v = (k == 0) ? xin : yl[k - 1];
        const float w = v - c[k].a1 * z1[k] - c[k].a2 * z2[k];
        const float out = c[k].b0 * w + c[k].b1 * z1[k] + c[k].b2 * z2[k];
        if (!kMask || (t - k >= 0 && t - k < s)) {
            z2[k] = z1[k];
            z1[k] = w;
        }
        yl[k] = out;
    }
}

// Quad g: steps 4g + K - 1 .. 4g + K + 2 (from `step`), which emit output samples
// 4g .. 4g + 3 into group gi = g % 8 of the lane's row `cur` of the chunk
// tile. Their inputs are the samples of those steps: the carried group
// win holds samples from step - D (D = (K - 1) % 4), the group after it, read
// here, the rest; that group becomes the carry. It lies gi + A / 4 + 1
// groups into cur, or into the next chunk's row nxt from 8 on.
template <int K, bool kMask>
__device__ __forceinline__ void cascade_quad(const Coeffs (&c)[K], float (&z1)[K],
                                             float (&z2)[K], float (&yl)[K],
                                             float (&win)[4], float* cur,
                                             const float* nxt, int gi, int step, int s) {
    constexpr int D = (K - 1) % 4;
    constexpr int A = K - 1 - D;
    const int j = gi + A / 4 + 1;
    const float4 next = *reinterpret_cast<const float4*>((j < 8) ? cur + 4 * j
                                                                 : nxt + 4 * (j - 8));
    const float nx[4] = {next.x, next.y, next.z, next.w};
    float o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float xin = (i + D < 4) ? win[i + D] : nx[i + D - 4];
        if (kMask && step + i >= s) xin = 0.f;  // past the input: stage 0 is dead
        cascade_step<K, kMask>(c, z1, z2, yl, xin, step + i, s);
        o[i] = yl[K - 1];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) win[i] = nx[i];
    *reinterpret_cast<float4*>(cur + 4 * gi) = make_float4(o[0], o[1], o[2], o[3]);
}

// The step ranges come from the host's schedule (ops/iir.py
// cascade_schedule): steps 0 .. K - 2 are the masked warm-up, quads
// 0 .. steady_quads - 1 run with no mask, quads steady_quads .. quads - 1
// (the drain, ending at step K - 2 + 4 * quads >= s + K - 2) with it.
// vec: 16-byte copies and stores (s % 4 == 0, x and y 16-byte aligned);
// pair: states moved as float2 (z_in and z_out 8-byte aligned).
template <int K, int kW, int kR, int kU>
__global__ void __launch_bounds__(kW * 32, CsDepth<K>::kMinWarps / kW)
iir_cascade_systolic_kernel(const float* __restrict__ x,
                            const float* __restrict__ coeffs,
                            const float* __restrict__ z_in,
                            float* __restrict__ y, float* __restrict__ z_out,
                            int tracks, int s, int steady_quads, int quads,
                            int chunks, int vec, int pair) {
    constexpr int L = K - 1;       // output lag, in steps
    constexpr int A = L - L % 4;   // first sample of quad 0's carried group
    extern __shared__ float4 cs_smem4[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long t0 = (static_cast<long long>(blockIdx.x) * kW + warp) * 32;
    if (t0 >= tracks) return;
    const int rows = static_cast<int>(min(32LL, tracks - t0));
    float* ring = reinterpret_cast<float*>(cs_smem4) + warp * kR * kCsTile;
    CASCADE_MARK(0);

    // Chunk c of the warp's 32 rows into slot c % kR, zeros past s and
    // past the last track; one commit group per call, empty past the end.
    auto load = [&](int c) {
        if (c < chunks) {
            float* dst = ring + (c % kR) * kCsTile;
            const int n0 = 32 * c;
            if (vec) {
                const int q = 4 * (lane & 7);
                const bool in_s = n0 + q < s;
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int r = (lane >> 3) + 4 * i;
                    const bool ok = in_s && r < rows;
                    cp_async16(dst + r * kCsPitch + q, ok ? x + (t0 + r) * s + n0 + q : x,
                               ok ? 16 : 0);
                }
            } else {
                const bool in_s = n0 + lane < s;
#pragma unroll 4
                for (int r = 0; r < 32; ++r) {
                    const bool ok = in_s && r < rows;
                    cp_async4(dst + r * kCsPitch + lane, ok ? x + (t0 + r) * s + n0 + lane : x,
                              ok ? 4 : 0);
                }
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
#pragma unroll
    for (int c = 0; c < kR; ++c) load(c);

    const long long t = t0 + lane;
    const bool live = lane < rows;
    Coeffs c[K];
    float z1[K], z2[K], yl[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        c[k] = load_coeffs(coeffs + 5 * k);
        float2 z = make_float2(0.f, 0.f);
        if (live) {
            const long long e = static_cast<long long>(k) * tracks + t;
            z = pair ? reinterpret_cast<const float2*>(z_in)[e]
                     : make_float2(z_in[2 * e], z_in[2 * e + 1]);
        }
        z1[k] = z.x;
        z2[k] = z.y;
        yl[k] = 0.f;
    }
    CASCADE_MARK(1);

    // Warm-up: steps 0 .. L - 1 from chunk 0; win ends as group A / 4.
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kR - 1) : "memory");
    __syncwarp();
    CASCADE_MARK(2);
    float win[4];
#pragma unroll
    for (int j = 0; j <= A / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(ring + lane * kCsPitch + 4 * j);
        win[0] = v.x;
        win[1] = v.y;
        win[2] = v.z;
        win[3] = v.w;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (4 * j + i < L) cascade_step<K, true>(c, z1, z2, yl, win[i], 4 * j + i, s);
        }
    }
    CASCADE_MARK(4);

    for (int o = 0; o < chunks; ++o) {
        // Chunks o and o + 1 are in; o + 2 .. o + kR - 1 may be in flight.
        asm volatile("cp.async.wait_group %0;\n" :: "n"(kR - 2) : "memory");
        __syncwarp();
        CASCADE_MARK(2);
        float* cur = ring + (o % kR) * kCsTile + lane * kCsPitch;
        const float* nxt = ring + ((o + 1) % kR) * kCsTile + lane * kCsPitch;
        const int g0 = 8 * o;
        const int g1 = min(g0 + 8, quads);
        const int gs = min(max(g0, steady_quads), g1);
        int g = g0;
        for (; g + kU <= gs; g += kU) {
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                cascade_quad<K, false>(c, z1, z2, yl, win, cur, nxt, g + u - g0,
                                       4 * (g + u) + L, s);
            }
        }
        for (; g < gs; ++g) cascade_quad<K, false>(c, z1, z2, yl, win, cur, nxt, g - g0, 4 * g + L, s);
        CASCADE_MARK(3);
        for (; g < g1; ++g) cascade_quad<K, true>(c, z1, z2, yl, win, cur, nxt, g - g0, 4 * g + L, s);
        CASCADE_MARK(4);
        __syncwarp();  // every lane's outputs of chunk o are in its slot

        // Output chunk o, along samples.
        const float* src = ring + (o % kR) * kCsTile;
        const int n0 = 32 * o;
        if (vec) {
            const int q = 4 * (lane & 7);
            if (n0 + q < s) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int r = (lane >> 3) + 4 * i;
                    if (r < rows) {
                        *reinterpret_cast<float4*>(y + (t0 + r) * s + n0 + q) =
                            *reinterpret_cast<const float4*>(src + r * kCsPitch + q);
                    }
                }
            }
        } else if (n0 + lane < s) {
#pragma unroll 4
            for (int r = 0; r < rows; ++r) y[(t0 + r) * s + n0 + lane] = src[r * kCsPitch + lane];
        }
        __syncwarp();  // the slot is read out: it takes chunk o + kR
        load(o + kR);
        CASCADE_MARK(5);
    }

    if (live) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const long long e = static_cast<long long>(k) * tracks + t;
            if (pair) {
                reinterpret_cast<float2*>(z_out)[e] = make_float2(z1[k], z2[k]);
            } else {
                z_out[2 * e] = z1[k];
                z_out[2 * e + 1] = z2[k];
            }
        }
    }
    CASCADE_MARK(7);
}

int grid_for(int tracks, int per_block) {
    return (tracks + per_block - 1) / per_block;
}

// cuTensorMapEncodeTiled, reached through the runtime so that the
// library needs no -lcuda.
using TensorMapEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                     const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                     const cuuint32_t*, CUtensorMapInterleave,
                                     CUtensorMapSwizzle, CUtensorMapL2promotion,
                                     CUtensorMapFloatOOBfill);

cudaError_t tensor_map_encoder(TensorMapEncode* fn) {
    static TensorMapEncode cached = nullptr;
    if (cached == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
        cached = reinterpret_cast<TensorMapEncode>(p);
    }
    *fn = cached;
    return cudaSuccess;
}

// The (tracks, s) float32 array at base as a map of 32 x 32 boxes (32
// samples = 128 bytes inner, 32 tracks outer), 128-byte swizzle, zeros
// past the edges on load. TMA takes rows of 4s bytes only when that is a
// multiple of 16, and a 16-byte aligned base.
cudaError_t chain_map(CUtensorMap* map, const float* base, int tracks, int s) {
    TensorMapEncode encode = nullptr;
    cudaError_t err = tensor_map_encoder(&encode);
    if (err != cudaSuccess) return err;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(tracks)};
    const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(s) * sizeof(float)};
    const cuuint32_t box[2] = {32, 32};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                              const_cast<float*>(base), dims, pitch, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

bool chain_tma_takes(const float* x, const float* y, int s) {
    return s % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(y) % 16 == 0;
}

// The chain cascade on the host's route and geometry (ops/iir.py
// chain_schedule): kTma the TMA route, which the shape and pointers must
// allow, else the staged route, which takes any; grid blocks of kChWarps
// warps (one a 32 tracks), chunks 32-sample chunks. A geometry that does
// not cover the shape is refused. The coefficients go into the constant
// bank by a copy on the stream just before the launch.
template <int K, bool kTma, int kRing, bool kConst>
cudaError_t launch_chain(const float* x, const float* coeffs, const float* z_in, float* y,
                         float* z_out, int tracks, int s, int grid, int chunks,
                         cudaStream_t st) {
    if (grid != grid_for(tracks, kChWarps * 32) || chunks != (s + 31) / 32 ||
        (kTma && !chain_tma_takes(x, y, s))) {
        return cudaErrorInvalidValue;
    }
    CUtensorMap x_map{}, y_map{};
    cudaError_t err = cudaSuccess;
    if constexpr (kTma) {
        err = chain_map(&x_map, x, tracks, s);
        if (err != cudaSuccess) return err;
        err = chain_map(&y_map, y, tracks, s);
        if (err != cudaSuccess) return err;
    }
    if constexpr (kConst) {
        err = cudaMemcpyToSymbolAsync(c_chain_coeffs, coeffs, 5 * K * sizeof(float), 0,
                                      cudaMemcpyDeviceToDevice, st);
        if (err != cudaSuccess) return err;
    }
    constexpr int bytes = (kTma ? kRing : 1) * kChWarps * kChTileBytes + kChAlign;
    auto kernel = iir_cascade_chain_kernel<K, kTma, kRing, kConst>;
    static int cached_dev = -1;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev != cached_dev) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return err;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return err;
        cached_dev = dev;
    }
    kernel<<<grid, kChWarps * 32, bytes, st>>>(x_map, y_map, x, coeffs, z_in, y, z_out,
                                               tracks, s, chunks);
    return cudaGetLastError();
}

// The systolic cascade on the host's schedule: `grid` blocks of kW warps
// (one warp per 32 tracks), steady steps up to steady_end, the drain up
// to drain_end, `chunks` 32-sample chunks. A schedule that does not cover
// the tracks and samples, or puts a step whose stages are not all live
// into the steady range, is refused.
template <int K, int kW, int kR, int kU>
cudaError_t launch_systolic(const float* x, const float* coeffs, const float* z_in,
                            float* y, float* z_out, int tracks, int s, int grid,
                            int steady_end, int drain_end, int chunks, cudaStream_t st) {
    constexpr int lag = K - 1;
    const int quads = (s + 3) / 4;
    if (grid < 1 || static_cast<long long>(grid) * kW * 32 < tracks ||
        static_cast<long long>(grid - 1) * kW * 32 >= tracks ||
        steady_end < lag || (steady_end - lag) % 4 != 0 ||
        (steady_end > lag && steady_end > s) || drain_end != lag + 4 * quads ||
        chunks != (s + 31) / 32) {
        return cudaErrorInvalidValue;
    }
    constexpr int bytes = kW * kR * kCsTile * static_cast<int>(sizeof(float));
    auto kernel = iir_cascade_systolic_kernel<K, kW, kR, kU>;
    static int cached_dev = -1;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev != cached_dev) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return err;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return err;
        cached_dev = dev;
    }
    const int vec = (s % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(y) % 16 == 0);
    const int pair = (reinterpret_cast<uintptr_t>(z_in) % 8 == 0) &&
                     (reinterpret_cast<uintptr_t>(z_out) % 8 == 0);
    kernel<<<grid, kW * 32, bytes, st>>>(x, coeffs, z_in, y, z_out, tracks, s,
                                         (steady_end - lag) / 4, quads, chunks, vec, pair);
    return cudaGetLastError();
}

// One or two blocks an SM (the occupancy API says which; one at m > 64),
// never more than the track groups need.
template <int NT>
cudaError_t launch_blockstate(const float* x, const float* coeffs,
                              const float* taps, const float* u,
                              const float* z_in, float* y, float* z_out,
                              int tracks, int s, int m, cudaStream_t st) {
    const int bytes = BsShape<NT>::kTotal * static_cast<int>(sizeof(float));
    static int cached_dev = -1, cached_blocks = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev != cached_dev) {
        err = cudaFuncSetAttribute(iir_blockstate_kernel<NT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return err;
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, iir_blockstate_kernel<NT>, kBsThreads, bytes);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        cached_blocks = sms * per_sm;
        cached_dev = dev;
    }
    const int groups = (tracks + kBsRows - 1) / kBsRows;
    const int blocks = std::min(cached_blocks, grid_for(groups, kBsWarps));
    // 16-byte copies and stores when every chunk row is 16-byte aligned.
    const int vec = (m % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(y) % 16 == 0);
    iir_blockstate_kernel<NT><<<blocks, kBsThreads, bytes, st>>>(
        x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, vec);
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

// Warps per block of the systolic cascade (the schedule's `warps`).
int iir_cascade_warps() { return kCsWarps; }

// Warps per block of the chain cascade (chain_schedule's `warps`).
int iir_chain_warps() { return kChWarps; }

// The systolic cascade on the schedule (grid, steady_end, drain_end,
// chunks) of ops/iir.py cascade_schedule. coeffs: (k, 5); z_in, z_out:
// (k, tracks, 2); 1 <= k <= iir_max_stages().
int iir_cascade_launch(const float* x, const float* coeffs, const float* z_in,
                       float* y, float* z_out, int tracks, int s, int k,
                       int grid, int steady_end, int drain_end, int chunks,
                       void* stream) {
    if (tracks <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (k) {
#define IIR_CASE(N)                                                                      \
    case N:                                                                              \
        err = launch_systolic<N, kCsWarps, kCsRing, kCsUnroll>(                          \
            x, coeffs, z_in, y, z_out, tracks, s, grid, steady_end, drain_end, chunks, st); \
        break;
        IIR_CASE(1) IIR_CASE(2) IIR_CASE(3) IIR_CASE(4) IIR_CASE(5) IIR_CASE(6)
        IIR_CASE(7) IIR_CASE(8) IIR_CASE(9) IIR_CASE(10) IIR_CASE(11)
        IIR_CASE(12) IIR_CASE(13) IIR_CASE(14) IIR_CASE(15) IIR_CASE(16)
#undef IIR_CASE
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err);
}

// The per-sample chain cascade on the route and geometry of ops/iir.py
// chain_schedule: route 0 TMA (S % 4 == 0, x and y 16-byte aligned),
// route 1 staged; grid = ceil(tracks / 128), chunks = ceil(s / 32).
// coeffs: (k, 5); z_in, z_out: (k, tracks, 2); 1 <= k <= iir_max_stages().
// It writes the constant bank's coefficients on the stream first: the
// port launches it on one stream, and two concurrent launches with other
// coefficients would race there.
int iir_cascade_chain_launch(const float* x, const float* coeffs, const float* z_in,
                             float* y, float* z_out, int tracks, int s, int k, int route,
                             int grid, int chunks, void* stream) {
    if (tracks <= 0 || s <= 0 || (route != 0 && route != 1)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (k) {
#define CHAIN_CASE(N)                                                                     \
    case N:                                                                               \
        err = route == 0 ? launch_chain<N, true, kChRing, true>(x, coeffs, z_in, y, z_out, \
                                                                tracks, s, grid, chunks, st) \
                         : launch_chain<N, false, 1, true>(x, coeffs, z_in, y, z_out,      \
                                                           tracks, s, grid, chunks, st);   \
        break;
        CHAIN_CASE(1) CHAIN_CASE(2) CHAIN_CASE(3) CHAIN_CASE(4) CHAIN_CASE(5)
        CHAIN_CASE(6) CHAIN_CASE(7) CHAIN_CASE(8) CHAIN_CASE(9) CHAIN_CASE(10)
        CHAIN_CASE(11) CHAIN_CASE(12) CHAIN_CASE(13) CHAIN_CASE(14) CHAIN_CASE(15)
        CHAIN_CASE(16)
#undef CHAIN_CASE
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
    const int nt = (m + 7) / 8;  // k-tiles of 8 samples, padded to 2, 4, 8, 16
    cudaError_t err;
    if (nt <= 2) {
        err = launch_blockstate<2>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    } else if (nt <= 4) {
        err = launch_blockstate<4>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    } else if (nt <= 8) {
        err = launch_blockstate<8>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    } else {
        err = launch_blockstate<16>(x, coeffs, taps, u, z_in, y, z_out, tracks, s, m, st);
    }
    return static_cast<int>(err);
}

}  // extern "C"
