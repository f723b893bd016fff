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
// it is bound by the FP32 issue rate, not by memory. The resonator issues
// 5 as well (see Rounding). The design keeps every SM's FP32 pipes fed
// and everything else out of the sample loop:
//   * Tiles. The modes are laid out as rows of width W = lcm(32, T_out).
//     A tile is P rows of 32 columns (P modes a thread: kMpt, or kMpt
//     halved down): tile g covers columns 32*(g mod W/32) .. +31 of rows
//     P*(g div W/32) .. +P-1, and lane l of the warp that takes it holds
//     one mode of each row,
//         mode = (g div W/32)*P*W + k*W + 32*(g mod W/32) + l,
//     so the loads are coalesced, and since W is a multiple of T_out every
//     mode of a thread folds onto the same track, (32*(g mod W/32) + l)
//     mod T_out: a thread's per-sample sum belongs to one track. At T_out
//     dividing 32 (the main path) W = 32: lane l folds onto l mod T_out.
//   * A persistent grid with a static schedule. The grid is as many
//     blocks as fit on the card at once (the occupancy API), never more
//     than there are tiles. Block b takes the contiguous tiles
//     [b*G/grid, (b+1)*G/grid) of the G tiles, so blocks differ by at most
//     one tile, and runs them in passes of kWarps tiles, one a warp. The
//     wrapper computes P, the grid and the passes (ops/modal.py:
//     modal_schedule) and passes them in. Each thread holds its P modes'
//     tables and states in registers for the whole pass: P independent
//     rotation chains a thread keep the pipes busy with one block of 12
//     rotation warps an SM, three on each of its four schedulers. P is
//     kMpt = 21 unless the tiles would then fill less than half of the
//     card's warps (small banks, such as the CLI's 12,288 modes, take
//     fewer modes a thread and more warps). At the main shape the 1,561
//     tiles of 21 rows fill the 132 SMs in one pass: no scheduler holds
//     more than 63 of the 62.06 rows it would hold in perfect balance (16
//     modes a thread on 16 warps held 64).
//   * No block-wide stall in the sample loop, and no fold in it. Each
//     rotation warp writes its per-sample sums of a kChunk-sample chunk
//     into one of kStages = 3 shared buffers and arrives on that buffer's
//     "full" mbarrier; it waits on the buffer's "empty" mbarrier only
//     before it writes the buffer again, three chunks later, so warps
//     that the schedulers favour run up to two chunks ahead of the
//     others before they wait. Four fold warps (one more warp on each of
//     the SM's four schedulers) wait on "full", fold the chunk into the
//     block's partial and arrive on "empty". The fold is
//     latency, not work: 16 loads and adds an entry. Done by the rotation
//     warps between chunks (as the kernel before this design did) it
//     leaves the FP32 pipes idle while they wait on it; in warps of their
//     own it runs beside the rotation, which keeps the pipes busy
//     (tools/modal_stages/ gives the phases of both kernels).
//   * No float atomics: a chunk's fold sums, for each (sample, track),
//     the warps in order and within a warp the lanes of that track in
//     order, into one (S, T_out) partial per block and pass; a second
//     kernel sums the partials in block (then pass) order, one thread an
//     output entry, the loads coalesced across threads. The order of
//     every sum depends only on (M, S, T_out, grid), so the output is the
//     same bits from run to run.
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

#include <cuda_runtime.h>

#include <cstdint>

// MODAL_MARK(q) marks the end of phase q of a warp's time: 0 the start,
// 1 the table loads, 2 the wait for an empty buffer, 3 the rotation and
// its shared-memory sums, 4 the wait for a full buffer, 5 the fold and
// its partial, 6 the state stores, 7 the end. tools/modal_stages/ defines
// it to sum clock64() phases; in the port it is empty.
#ifndef MODAL_MARK
#define MODAL_MARK(q)
#endif

namespace {

constexpr int kWarps = 12;     // rotation warps a block
constexpr int kFoldWarps = 4;  // fold warps a block, one a scheduler
constexpr int kMpt = 21;    // most modes a thread holds, one a row of its tile
constexpr int kChunk = 32;  // samples a thread sums before a fold
constexpr int kStages = 3;  // shared buffers of chunk sums
constexpr int kReduceThreads = 128;

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// Row width W = lcm(32, T_out), in modes.
int row_width(int t_out) { return 32 / gcd(32, t_out) * t_out; }

// Tiles of mpt rows x 32 columns covering m modes.
long long num_tiles(int m, int t_out, int mpt) {
    const long long w = row_width(t_out);
    return (m + mpt * w - 1) / (mpt * w) * (w / 32);
}

template <int Warps>
constexpr int smem_bytes() {
    return kStages * Warps * kChunk * 32 * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// Waits until the phase of the given parity of *bar has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    } while (!done);
}

// Folds one chunk (len samples from n0) into part; thread i of the n
// folding threads takes every n-th task. Entry (j, t) sums the rotation
// warps in order, and within a warp the lanes that fold onto t, in order;
// the warps past the first `active` have no tile in this pass and left
// zeros, which add nothing. At T_out = 32 (one lane of each warp a track,
// shift 0) entry (j, t) is offset e = 32 j + t of each warp's sums, and a
// task is four entries e .. e + 3, one 16-byte load a warp, all of them
// in flight at once. Other T_out take one entry a task and skip the
// zeros (a small bank leaves most warps without a tile); cols = W / 32 >
// 1 needs each warp's shift.
template <int Warps>
__device__ __forceinline__ void fold(const float* __restrict__ sums,
                                     const int* shift, float* __restrict__ part,
                                     int n0, int len, int t_out, int cols,
                                     int active, int i, int n) {
    if (t_out == 32) {
        const float4* src = reinterpret_cast<const float4*>(sums);
        float4* dst = reinterpret_cast<float4*>(part + static_cast<size_t>(n0) * 32);
        for (int e4 = i; e4 < len * 8; e4 += n) {
            float4 sum = src[e4];
#pragma unroll
            for (int w = 1; w < Warps; ++w) {
                const float4 v = src[w * kChunk * 8 + e4];
                sum.x += v.x;
                sum.y += v.y;
                sum.z += v.z;
                sum.w += v.w;
            }
            dst[e4] = sum;
        }
        return;
    }
#pragma unroll 2
    for (int e = i; e < len * t_out; e += n) {
        const int j = e / t_out;
        const int t = e - j * t_out;
        const float* row = sums + j * 32;
        float sum = 0.f;
        for (int w = 0; w < active; ++w) {
            int l = t;
            if (cols > 1) {
                l -= shift[w];
                if (l < 0) l += t_out;
            }
            for (; l < 32; l += t_out) sum += row[w * kChunk * 32 + l];
        }
        part[static_cast<size_t>(n0 + j) * t_out + t] = sum;
    }
}

// kRes: the resonator (a = eps, b unused, s0 = y, s1 = q); otherwise the
// rotation (a = cos, b = sin, s0 = re, s1 = im, amp optional). FoldWarps
// fold warps (warps 0 ..), then Warps rotation warps. partials holds
// gridDim.x * passes (S, T_out) partials, block-major.
template <bool kRes, int Mpt, int Warps, int FoldWarps>
__global__ void __launch_bounds__((Warps + FoldWarps) * 32, 1)
modal_bank_kernel(const float* __restrict__ a_in,
                  const float* __restrict__ b_in,
                  const float* __restrict__ amp,
                  const float* __restrict__ s0_in,
                  const float* __restrict__ s1_in,
                  float* __restrict__ s0_out,
                  float* __restrict__ s1_out,
                  float* __restrict__ partials,
                  int m, int s, int t_out, int row_w, long long tiles,
                  int passes) {
    extern __shared__ float4 lane_sums4[];  // [kStages][Warps][kChunk][32] floats
    float* lane_sums = reinterpret_cast<float*>(lane_sums4);
    __shared__ int shift[kStages][Warps];  // per buffer: warp w's track shift
    __shared__ uint64_t bars[2 * kStages];  // full[kStages], then empty[kStages]
    const int lane = threadIdx.x & 31;
    const int cols = row_w / 32;
    const long long lo = blockIdx.x * tiles / gridDim.x;
    const long long hi = (blockIdx.x + 1LL) * tiles / gridDim.x;
    if (threadIdx.x == 0) {
        for (int i = 0; i < 2 * kStages; ++i) {
            const int count = (i < kStages ? Warps : FoldWarps) * 32;
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                         :: "r"(smem_addr(&bars[i])), "r"(count) : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    MODAL_MARK(0);
    auto pass_part = [&](int p) {  // the (S, T_out) partial of pass p
        return partials + (static_cast<size_t>(blockIdx.x) * passes + p) * s * t_out;
    };

    // q counts the chunks of this block, over all passes; chunk q lives in
    // buffer q % kStages, and its barriers' phase is (q / kStages) & 1.
    if (static_cast<int>(threadIdx.x) < FoldWarps * 32) {  // a fold warp
        int q = 0;
        for (int p = 0; p < passes; ++p) {
            const long long left = hi - lo - static_cast<long long>(p) * Warps;
            const int active = static_cast<int>(left < Warps ? left : Warps);
            for (int n0 = 0; n0 < s; n0 += kChunk, ++q) {
                const int buf = q % kStages;
                mbar_wait(&bars[buf], (q / kStages) & 1);
                MODAL_MARK(4);
                fold<Warps>(lane_sums + buf * Warps * kChunk * 32, shift[buf],
                            pass_part(p), n0, min(kChunk, s - n0), t_out, cols,
                            active, threadIdx.x, FoldWarps * 32);
                mbar_arrive(&bars[kStages + buf]);
                MODAL_MARK(5);
            }
        }
        MODAL_MARK(7);
        return;
    }
    const int warp = (threadIdx.x >> 5) - FoldWarps;  // rotation warp

    int q = 0;
    for (int p = 0; p < passes; ++p) {
        const long long first = lo + static_cast<long long>(p) * Warps;
        const bool mine = first + warp < hi;
        const long long tile = first + warp;
        const int col = mine ? static_cast<int>(tile % cols) : 0;
        const long long base =
            mine ? tile / cols * Mpt * row_w + 32LL * col : 0;

        // Modes past the ragged edge hold a zero state under a unit
        // rotation (or a zero shear): they add nothing and are never
        // stored.
        float a[Mpt], b[Mpt], s0[Mpt], s1[Mpt];
#pragma unroll
        for (int k = 0; k < Mpt; ++k) {
            const long long mode = base + static_cast<long long>(k) * row_w + lane;
            if (mine && mode < m) {
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
        MODAL_MARK(1);

        for (int n0 = 0; n0 < s; n0 += kChunk, ++q) {
            const int len = min(kChunk, s - n0);
            const int buf = q % kStages;
            if (q >= kStages) mbar_wait(&bars[kStages + buf], (q / kStages - 1) & 1);
            MODAL_MARK(2);
            float* sums = lane_sums + (buf * Warps + warp) * kChunk * 32;
            if (mine) {
#pragma unroll 4
                for (int j = 0; j < len; ++j) {
                    float acc;
#pragma unroll
                    for (int k = 0; k < Mpt; ++k) {
                        if (kRes) {
                            s1[k] = __fsub_rn(s1[k], __fmul_rn(a[k], s0[k]));
                            s0[k] = __fadd_rn(s0[k], __fmul_rn(a[k], s1[k]));
                        } else {
                            const float r = s0[k] * a[k] - s1[k] * b[k];
                            s1[k] = s0[k] * b[k] + s1[k] * a[k];
                            s0[k] = r;
                        }
                        acc = k == 0 ? s0[k] : acc + s0[k];
                    }
                    sums[j * 32 + lane] = acc;
                }
            } else {
                for (int j = 0; j < len; ++j) sums[j * 32 + lane] = 0.f;
            }
            if (lane == 0) shift[buf][warp] = (32 * col) % t_out;
            mbar_arrive(&bars[buf]);
            MODAL_MARK(3);
        }

        if (s0_out != nullptr && mine) {
#pragma unroll
            for (int k = 0; k < Mpt; ++k) {
                const long long mode = base + static_cast<long long>(k) * row_w + lane;
                if (mode < m) {
                    s0_out[mode] = s0[k];
                    s1_out[mode] = s1[k];
                }
            }
        }
        MODAL_MARK(6);
    }
    MODAL_MARK(7);
}

// out[n, t] (or out[t, n] when track_major) = sum over partials p, in
// order, of partials[p, n, t]; one thread an entry, so each of the
// n_partials loads is coalesced across the threads.
__global__ void __launch_bounds__(kReduceThreads)
modal_bank_reduce(const float* __restrict__ partials, float* __restrict__ out,
                  int n_partials, int s, int t_out, int track_major) {
    const int total = s * t_out;
    const int e = blockIdx.x * kReduceThreads + threadIdx.x;
    if (e >= total) return;
    float sum = 0.f;
#pragma unroll 32
    for (int p = 0; p < n_partials; ++p) {
        sum += partials[static_cast<size_t>(p) * total + e];
    }
    const int n = e / t_out;
    const int t = e - n * t_out;
    out[track_major ? static_cast<size_t>(t) * s + n : static_cast<size_t>(e)] = sum;
}

// Blocks of modal_bank_kernel<kRes, Mpt, Warps, FoldWarps> that fit on the current
// device at once, or a negative CUDA error.
template <bool kRes, int Mpt, int Warps, int FoldWarps = kFoldWarps>
int capacity() {
    static int cached_dev = -1, cached = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (dev != cached_dev) {
        auto* kernel = modal_bank_kernel<kRes, Mpt, Warps, FoldWarps>;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes<Warps>());
        if (err != cudaSuccess) return -static_cast<int>(err);
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return -static_cast<int>(err);
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, (Warps + FoldWarps) * 32, smem_bytes<Warps>());
        if (err != cudaSuccess) return -static_cast<int>(err);
        if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
        cached = sms * per_sm;
        cached_dev = dev;
    }
    return cached;
}

template <bool kRes, int Mpt, int Warps = kWarps, int FoldWarps = kFoldWarps>
int launch_mpt(const float* a, const float* b, const float* amp,
               const float* s0_in, const float* s1_in, float* s0_out,
               float* s1_out, float* partials, float* out, int m, int s,
               int t_out, int track_major, int grid, int passes, void* stream) {
    // The schedule must cover every tile: ceil(tiles / grid) <= passes * Warps.
    const long long tiles = num_tiles(m, t_out, Mpt);
    if (grid < 1 || grid > tiles || passes < 1 ||
        (tiles + grid - 1) / grid > static_cast<long long>(passes) * Warps) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int cap = capacity<kRes, Mpt, Warps, FoldWarps>();  // sets the shared-memory limit
    if (cap < 0) return -cap;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    modal_bank_kernel<kRes, Mpt, Warps, FoldWarps>
        <<<grid, (Warps + FoldWarps) * 32, smem_bytes<Warps>(), st>>>(
        a, b, amp, s0_in, s1_in, s0_out, s1_out, partials, m, s, t_out,
        row_width(t_out), tiles, passes);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int total = s * t_out;
    modal_bank_reduce<<<(total + kReduceThreads - 1) / kReduceThreads,
                        kReduceThreads, 0, st>>>(partials, out, grid * passes, s,
                                                 t_out, track_major);
    return static_cast<int>(cudaGetLastError());
}

// Modes a thread: kMpt, halved (rounding down) as often as the schedule
// needs to keep half of the card's warps busy, down to 1.
template <bool kRes>
int launch(const float* a, const float* b, const float* amp,
           const float* s0_in, const float* s1_in, float* s0_out,
           float* s1_out, float* partials, float* out, int m, int s,
           int t_out, int track_major, int mpt, int grid, int passes,
           void* stream) {
    if (m <= 0 || s <= 0 || t_out <= 0 || m % t_out != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (mpt) {
#define MODAL_CASE(N)                                                             \
    case N:                                                                       \
        return launch_mpt<kRes, N>(a, b, amp, s0_in, s1_in, s0_out, s1_out,      \
                                   partials, out, m, s, t_out, track_major, grid, \
                                   passes, stream);
        MODAL_CASE(kMpt) MODAL_CASE(kMpt / 2) MODAL_CASE(kMpt / 4)
        MODAL_CASE(kMpt / 8) MODAL_CASE(kMpt / 16)
#undef MODAL_CASE
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" {

// The geometry ops/modal.py's schedule is computed for: rotation warps a
// block, and the most modes a thread (the kernel is built for it and for
// each of its halvings, rounding down, to 1).
int modal_bank_warps() { return kWarps; }
int modal_bank_max_modes_per_thread() { return kMpt; }

// Blocks of the rotation (res = 0) or resonator kernel that fit on the
// current device at once; a negative CUDA error on failure.
int modal_bank_capacity(int res) {
    return res ? capacity<true, kMpt, kWarps>() : capacity<false, kMpt, kWarps>();
}

// Rotation form. amp may be null (states already amp-prefolded); re_out
// and im_out may both be null (states not wanted). No output may alias an
// input (the pointers are __restrict__). m must be a multiple of t_out;
// mpt (modes a thread), grid and passes come from the schedule, and
// partials holds grid * passes (s, t_out) partials. Returns
// cudaGetLastError() after the launches (0 on success).
int modal_bank_launch(const float* cos_w, const float* sin_w,
                      const float* amp, const float* re_in,
                      const float* im_in, float* re_out, float* im_out,
                      float* partials, float* out,
                      int m, int s, int t_out, int track_major,
                      int mpt, int grid, int passes, void* stream) {
    return launch<false>(cos_w, sin_w, amp, re_in, im_in, re_out, im_out,
                         partials, out, m, s, t_out, track_major, mpt, grid,
                         passes, stream);
}

// Resonator form on (eps, y, q); y_out and q_out may both be null.
int modal_res_launch(const float* eps, const float* y_in, const float* q_in,
                     float* y_out, float* q_out, float* partials, float* out,
                     int m, int s, int t_out, int track_major, int mpt,
                     int grid, int passes, void* stream) {
    return launch<true>(eps, nullptr, nullptr, y_in, q_in, y_out, q_out,
                        partials, out, m, s, t_out, track_major, mpt, grid,
                        passes, stream);
}

}  // extern "C"
