// 3-D FDTD room acoustics for Hopper (sm_90a): one block of S samples x 3
// substeps in one launch, bound through a plain C interface
// (gpuaudiobench_tpu_torch/utils/build.py loads it with ctypes).
//
// Each form replaces one Pallas kernel of
// gpuaudiobench_tpu/ops/fdtd3d_pallas.py:
//   * the divergence form replaces _fdtd_kernel_div
//     (fdtd3d_block_pallas_div), the production form. It carries (p, div v)
//     on an N^3 grid; with the velocity update substituted into the
//     divergence, an interior cell does
//         div' = (div + 6*k1*p) - k1 * (sum of the 6 neighbours' p)
//         p'   = p - k2 * div'
//     and a boundary cell p' = p * (1 - absorption). div' is zero off the
//     interior, which is what the JAX wrapper returns after its re-mask.
//   * the field form replaces _fdtd_kernel (fdtd3d_block_pallas), with the
//     staggered velocities vx (N+1, N, N), vy (N, N+1, N), vz (N, N, N+1)
//     (ops/fdtd3d.py:_fdtd_substep). It also serves the per-track
//     receivers, which the JAX package runs on XLA only: each block writes
//     the rows whose receiver lies in its plane.
// At the start of each sample the source cell gets src[n] (the sum of all
// tracks x 0.1, computed by the wrapper); after the sample's third
// substep every receiver row t reads out[t, n] = p[rcv(t)] * 0.1, from
// one broadcast receiver cell or from a cell per track. A receiver on the
// source cell reads the value from before the next sample's injection.
// Each product, sum and difference is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn), in the JAX expressions' order, so every kernel
// gives the plain twin's bits.
//
// What bounds it: operations, and the hand-offs. At room 50 (52^3 cells,
// 50^3 interior) a div block is 1,536 substeps x (11 FLOP x 125,000
// interior cells + 1 x 15,608 boundary cells) = 2.1 GFLOP, 0.032 ms at 67
// TFLOP/s of FP32 (the field form about 16 FLOP a cell, 0.049 ms). Every
// substep reads the neighbours' p of the substep before, so all cells
// meet 1,536 times per block.
//
// Each kernel's route is chosen before the launch by
// ops/fdtd3d.py:fdtd_schedule (never by a failed launch), which also
// hands it its ranges. The divergence form has two:
//
// The cluster route (fdtd_div_cluster_kernel), for rooms whose (p, div)
// fit in one thread-block cluster's shared memory (up to 16 blocks x 227
// KB: rooms up to 65; room 50 takes 16 blocks of 8,788 cells). The TPU
// kernel kept the whole grid in VMEM for the block; here the cluster's
// distributed shared memory holds it from the prologue to the epilogue:
//   * Block r of the cluster owns the flat cells [start[r], start[r + 1])
//     of the schedule's balanced ranges, at least N^2 of them, so a +-1,
//     +-N or +-N^2 neighbour lies in its own range or an adjacent block's.
//     Thread t owns cells t, t + 1024, ... of the range, the same in every
//     substep, and keeps their p and div in registers (only the owner
//     reads div); a cell's boundary bit is computed once, in the prologue.
//     There is a build for each odd count of cells a thread, so all but the
//     last two iterations run unguarded (the last partial one's loads land
//     in padding, its stores are masked).
//   * p ping-pongs between two shared-memory buffers, each with a halo of
//     N^2 cells on either side of the range, so every stencil read is a
//     local shared-memory load. The owner of an edge cell also stores its
//     new p from registers into the neighbour's halo (st.async to
//     shared::cluster), which completes on the neighbour's mbarrier (one a
//     buffer); the neighbour's one arrival a phase announces the bytes it
//     awaits. A block waits only for its two neighbours: no cluster barrier
//     runs inside the loop (one costs 0.77 us on the H100 at 16 blocks: its
//     release / acquire is a GPU-scope fence and an L1 invalidation;
//     PERF.md). The cells that read a halo are the ones that send into the
//     other block, each after its loads, so receiving a neighbour's values
//     also proves that it has read what this block's next stores
//     overwrite. The edge cells go first in a substep, so that their
//     stores travel while the other cells are computed.
//   * The source cell's owner adds src[n + 1] when it writes the last
//     substep of sample n, and keeps the value from before in shared
//     memory; the receiver is read by the block that owns its cell.
//   * The inputs are read once in the prologue (range and halos), the
//     outputs written once in the epilogue; a cluster barrier after the
//     prologue (every block started, its mbarriers initialised) and one
//     before exit.
//
// The plane route (fdtd_div_planes_kernel), for the rooms one cluster
// cannot hold (66 to 128; room 128 is 130^3 cells, 8.8 MB of p): one
// persistent cooperative launch (cudaLaunchCooperativeKernel, which
// refuses a grid that cannot be resident at once, where a plain launch of
// this kernel would hang) of one block of 1,024 threads a plane, n <= 130
// blocks on the H100's 132 SMs; the launcher checks the occupancy at the
// plan's shared memory first and raises, never falls back.
//   * Block b owns x-plane b, the flat cells [b n^2, (b + 1) n^2). An
//     interior cell's +-1 and +-n neighbours lie in its own plane; only
//     the +-n^2 ones lie in the adjacent blocks' planes. (Half a plane a
//     block would put +-n across blocks too, and an even split needs 2n <=
//     132 blocks: rooms up to 64, which the cluster route takes.)
//   * Thread t owns cells t, t + 1024, ... of the plane and keeps their p
//     and div in registers, as in the cluster kernel, with the same
//     unguarded loop, boundary bits and per-cell update (div_cell); the
//     plane's p ping-pongs between two shared buffers, with no halo (room
//     128's two are 2 x 72.8 KB).
//   * The hand-off goes through L2, with no grid barrier: after substep k
//     every thread stores its new p also into the block's slot of a
//     global exchange buffer of two parities (st.global.cg), the block
//     meets a __syncthreads, and one thread stores k + 1 into the block's
//     flag with st.release.gpu. Before substep k + 1 two threads wait for
//     the two neighbours' flags to reach k + 1 (ld.acquire.gpu), the block
//     meets a second __syncthreads, and the neighbours' planes are read
//     with ld.global.cg (through L2: a line in L1 could be a substep or
//     two old).
//   * Why two parities suffice: substep k writes slot parity (k + 1) & 1,
//     which the neighbours last read in substep k - 1. Block b starts
//     substep k only after both neighbours' flags reach k, and a
//     neighbour stores k only after a __syncthreads that follows all of
//     its loads of substep k - 1. So no slot is overwritten while a
//     neighbour may still read it, and no block runs more than one
//     substep ahead of a neighbour.
//   * The flags are reset and the input planes published in the
//     prologue, followed by one cg::grid sync (the only one).
//   * The source cell's owner injects as in the cluster kernel; the
//     receiver is read by the block that owns its cell.
//
// The field form takes the plane route at every room
// (fdtd_field_planes_kernel, ops/fdtd3d.py:plane_schedule(n, "field")):
// the div plane kernel's launch, exchange, flags and argument for two
// parities, with p the only field that crosses blocks. A block keeps a
// replica of the vx faces above its plane and updates it from the next
// plane's p exactly as their owner does, so the faces never travel; the
// faces in y and z stay in the plane (in registers up to 7 cells a
// thread, room 82; in shared memory above, with one more __syncthreads a
// substep). The receivers are bucketed by plane on the host
// (ops/fdtd3d.py:receiver_csr). It replaced a grid-stride cooperative
// kernel with a grid barrier a substep (1.40-1.43 us of ~3.6 at room 50;
// PERF.md), which lives on, measured, in tools/fdtd_stages, beside a
// cluster form (four fields in shared memory, two hand-offs a substep)
// that ran no faster.
//
// FDTD_MARK(q) is a measurement hook of tools/fdtd_stages (clock64()
// phase sums): unless defined before this file it compiles to nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

struct Grid {
    int n;            // cells per axis
    int cells;        // n^3
    int s;            // samples in the block
    int src_cell;     // flat index of the source cell
    int tracks;       // rows of out
    int rcv_cell;     // the broadcast receiver, when rcv_rows is null
    const int* rcv_rows;  // (tracks,) flat receiver cells, or null
    float k1, k2, c6, absorb, out_scale;
};

__device__ __forceinline__ bool on_boundary(int x, int y, int z, int n) {
    return x == 0 || x == n - 1 || y == 0 || y == n - 1 || z == 0 ||
           z == n - 1;
}

// One face's velocity after the update v + (-k1) * (p_hi - p_lo).
__device__ __forceinline__ float face(float v, float p_hi, float p_lo,
                                      float k1) {
    return __fadd_rn(v, __fmul_rn(-k1, __fsub_rn(p_hi, p_lo)));
}

// ---- the cluster route ------------------------------------------------

#ifndef FDTD_MARK
#define FDTD_MARK(q)
#endif
constexpr int kClusterThreads = 1024;
constexpr int kMaxClusterBlocks = 16;
// Builds for each odd count of cells a thread up to this; a build of CPT
// serves ranges that need CPT, CPT - 1 or CPT - 2 iterations.
constexpr int kMaxCellsPerThread = 19;

// The cluster's ranges, as ops/fdtd3d.py:fdtd_schedule gives them: block
// r owns the flat cells [start[r], start[r + 1]); cap is the longest
// range, to which every block's layout is sized. A kernel takes them as a
// __grid_constant__ parameter, read in place (no local copy).
struct Ranges {
    int start[kMaxClusterBlocks + 1];
    int cap;
};

// Floats of a shared-memory array of `cells` slots plus padding: one
// iteration of 1,024 cells and a few more, so that the last iteration of a
// range loads in bounds for every thread (only its stores are masked to
// the range).
__host__ __device__ __forceinline__ int padded(long long cells) {
    return static_cast<int>((cells + 12 + 1024 + 3) & ~3LL);
}

// One block's place in the cluster.
struct Slab {
    int rank, blocks;
    int start, end;  // the block's range of flat cells
    int prev_start;  // the previous block's first cell (0 for block 0)
    int cap;         // the longest range
};

__device__ __forceinline__ Slab make_slab(const Ranges& r) {
    cg::cluster_group cluster = cg::this_cluster();
    Slab sl;
    sl.rank = static_cast<int>(cluster.block_rank());
    sl.blocks = static_cast<int>(cluster.num_blocks());
    sl.start = r.start[sl.rank];
    sl.end = r.start[sl.rank + 1];
    sl.prev_start = sl.rank > 0 ? r.start[sl.rank - 1] : 0;
    sl.cap = r.cap;
    return sl;
}

// ---- halo hand-off between neighbouring blocks
//
// A block's copy of an array holds cells from an origin org (the first
// halo cell) at slot c - org. The owner of an edge cell stores its new
// value straight from registers into the neighbour's halo slot with
// st.async (shared::cluster), which completes on the neighbour's
// mbarrier; the neighbour's one arrival a phase announces the bytes it
// awaits, so the phase completes when all its halo values have landed.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `addr` (a shared::cta address of this
// block) in block `rank` of the cluster.
__device__ __forceinline__ uint32_t in_rank(uint32_t addr, int rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
                 : "memory");
}

// The block's one arrival of a phase, with the bytes the phase awaits.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
}

// Waits for the phase of the given parity to complete; acquires at
// cluster scope what the neighbours' st.async released.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
            "[%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(addr), "r"(parity)
            : "memory");
    }
}

// v into shared::cluster address dst, counted on the mbarrier at bar (a
// shared::cluster address of the same block).
__device__ __forceinline__ void store_async(uint32_t dst, float v,
                                            uint32_t bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
        "[%2];" ::"r"(dst),
        "r"(__float_as_uint(v)), "r"(bar)
        : "memory");
}

// Shared-memory load and store at a shared::cta address. A load is free
// to move: every iteration runs unguarded, within the padding, and a
// substep's loads read only the buffer no one writes in that substep.
__device__ __forceinline__ float lds(uint32_t addr) {
    float v;
    asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
    return v;
}

__device__ __forceinline__ void sts(uint32_t addr, float v) {
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void sts_if(bool ok, uint32_t addr, float v) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %0, 0;\n\t"
        "@p st.shared.f32 [%1], %2;\n\t}" ::"r"(static_cast<uint32_t>(ok)),
        "r"(addr), "f"(v)
        : "memory");
}

// A value the compiler must treat as new: a substep's base addresses and
// masks pass through it, so that per-cell values are rebuilt from one
// register each substep instead of being hoisted out of the loop (and
// spilled).
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
    asm volatile("" : "+r"(v));
    return v;
}

__device__ __forceinline__ float opaque(float v) {
    asm volatile("" : "+f"(v));
    return v;
}

// Whether iteration i of a build of CPT runs in a block of `iters`
// iterations (CPT - 2 <= iters <= CPT: the launch rounds the longest
// range's iterations up to odd, and ranges differ by one cell): only the
// last two are guarded, so the others run unguarded.
template <int CPT>
__device__ __forceinline__ bool runs(int i, int iters) {
    return i < CPT - 2 || i < iters;
}

// The iteration of a thread's CPT cells that comes j-th: from both ends
// of the range inward, so that the first and last nn cells, which go to
// the neighbours, are sent early.
template <int CPT>
__device__ __forceinline__ constexpr int outside_in(int j) {
    return (j & 1) ? CPT - 1 - j / 2 : j / 2;
}

// Where this thread's cell l = tid (then + 1024 i) of an array lands in
// the copy of block `rank`, whose origin is org_to; and that block's
// mbarrier.
struct Remote {
    uint32_t slot, bar;

    __device__ __forceinline__ Remote(const float* arr, int org_to, int cell0,
                                      uint64_t* mbar, int rank) {
        slot = in_rank(smem_u32(arr), rank) +
               4u * static_cast<uint32_t>(cell0 + threadIdx.x - org_to);
        bar = in_rank(smem_u32(mbar), rank);
    }
};

// p of cell c at the start of the block: the input, with src[0] injected
// at the source cell.
__device__ __forceinline__ float p_at_start(const Grid& g, const float* p_in,
                                            const float* src, int c) {
    const float v = p_in[c];
    return c == g.src_cell ? __fadd_rn(v, src[0]) : v;
}

// A block's cells [start, start + len) at the start of the block, thread
// t's at l = t + 1024 i, i < CPT: p (src[0] injected) into pr and own[l],
// div on the interior into dv (0 elsewhere), the bits of the thread's
// valid and interior cells, and which of them is the source cell (-1 for
// none). Both kernels of the divergence form take them so.
template <int CPT>
__device__ __forceinline__ void load_cells(
    const Grid& g, int start, int len, const float* src, const float* p_in,
    const float* div_in, float* own, float (&pr)[CPT], float (&dv)[CPT],
    unsigned& valid, unsigned& interior, int& src_i) {
    const int n = g.n, nn = n * n;
    valid = interior = 0;
    src_i = -1;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const int l = i * kClusterThreads + threadIdx.x;
        pr[i] = dv[i] = 0.f;
        if (l < len) {
            const int c = start + l;
            const int x = c / nn, y = (c / n) % n, z = c % n;
            valid |= 1u << i;
            pr[i] = p_at_start(g, p_in, src, c);
            own[l] = pr[i];
            if (c == g.src_cell) src_i = i;
            if (!on_boundary(x, y, z, n)) {
                interior |= 1u << i;
                dv[i] = div_in[c];
            }
        }
    }
}

// The block's cells' p' and div' (zero off the interior) from registers.
template <int CPT>
__device__ __forceinline__ void store_cells(int start, int len,
                                            const float (&pr)[CPT],
                                            const float (&dv)[CPT],
                                            float* p_out, float* div_out) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const int l = i * kClusterThreads + threadIdx.x;
        if (l < len) {
            p_out[start + l] = pr[i];
            div_out[start + l] = dv[i];
        }
    }
}

// One cell's substep in the divergence form, from its p and div and the
// sums of its neighbours' p in pairs along x, y and z, each operation
// rounded on its own in the twin's order: returns p' (p * (1 -
// absorption) off the interior); div' replaces dv on the interior. Both
// values are computed and one selected, so a warp never diverges on the
// boundary bit.
__device__ __forceinline__ float div_pairs(float pc, float& dv, bool in,
                                           float xx, float yy, float zz,
                                           float k1, float k2, float c6,
                                           float absorb) {
    const float sum = __fadd_rn(__fadd_rn(xx, yy), zz);
    const float d = __fsub_rn(__fadd_rn(dv, __fmul_rn(c6, pc)),
                              __fmul_rn(k1, sum));
    const float vi = __fsub_rn(pc, __fmul_rn(k2, d));
    const float vb = __fmul_rn(pc, absorb);
    dv = in ? d : dv;
    return in ? vi : vb;
}

// The same from the six neighbours' p in +-x, +-y, +-z order.
__device__ __forceinline__ float div_cell(float pc, float& dv, bool in,
                                          float xp, float xm, float yp,
                                          float ym, float zp, float zm,
                                          float k1, float k2, float c6,
                                          float absorb) {
    return div_pairs(pc, dv, in, __fadd_rn(xp, xm), __fadd_rn(yp, ym),
                     __fadd_rn(zp, zm), k1, k2, c6, absorb);
}

// Rows of out for sample smp, each written by the block that owns its
// receiver's cell (rank 0 writes NaN for a cell outside the grid). own
// points at the block's own range of p; src_pre holds the source cell's
// value from before the injection of sample smp + 1.
__device__ void cluster_receivers(const Grid& g, const Slab& sl, int smp,
                                  const float* own, const float* src_pre,
                                  float* out) {
    const bool injected = smp + 1 < g.s;
    for (int t = threadIdx.x; t < g.tracks; t += kClusterThreads) {
        const int cell = g.rcv_rows ? g.rcv_rows[t] : g.rcv_cell;
        float v;
        if (cell < 0 || cell >= g.cells) {
            if (sl.rank != 0) continue;
            v = __int_as_float(0x7fc00000);
        } else if (cell < sl.start || cell >= sl.end) {
            continue;
        } else if (injected && cell == g.src_cell) {
            v = *src_pre;
        } else {
            v = own[cell - sl.start];
        }
        out[static_cast<long long>(t) * g.s + smp] = __fmul_rn(v, g.out_scale);
    }
}

// Divergence form. Shared memory: two mbarriers (one a p buffer), the
// source cell's pre-injection value, then two p buffers of
// padded(cap + 2 nn) floats holding cells [start - nn, end + nn) from the
// origin start - nn. Thread t owns local cells l = i * 1024 + t, i < CPT
// (the launch takes the build of ceil(longest range / 1024) rounded up to
// odd; of the iterations that run, only the last is partial: its loads
// stay in the padding, its stores are masked), and keeps their p and div
// in registers: a substep reads 6 neighbours
// from shared memory and writes p once, and the owners of the first and
// last nn cells also store p into the neighbours' halos of the same
// buffer. Waiting for the neighbours' stores into this block's halos also
// proves that they have read what this block's next stores overwrite:
// the cells that read a halo are the ones that send into the other
// block's halo, and each sends after its loads.
template <int CPT>
__global__ void __launch_bounds__(kClusterThreads, 1)
fdtd_div_cluster_kernel(Grid g,
                        const __grid_constant__ Ranges ranges,
                        const float* __restrict__ src,
                        const float* __restrict__ p_in,
                        const float* __restrict__ div_in,
                        float* __restrict__ p_out,
                        float* __restrict__ div_out,
                        float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    FDTD_MARK(0);
    const int n = g.n, nn = n * n, tid = threadIdx.x;
    const Slab sl = make_slab(ranges);
    uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);
    float* const src_pre = smem + 4;
    const int w = padded(sl.cap + 2LL * nn);
    float* const buf0 = smem + 8;
    float* const buf1 = buf0 + w;
    const int len = sl.end - sl.start;
    const bool has_prev = sl.rank > 0, has_next = sl.rank + 1 < sl.blocks;
    // The bytes each phase awaits: the previous block's last nn cells and
    // the next block's first nn.
    const int expect = 4 * nn * (int{has_prev} + int{has_next});
    // The constants in registers (not reloaded from the constant bank in
    // every cell), and the pre-injection value's address.
    const float k1 = opaque(g.k1), k2 = opaque(g.k2), c6 = opaque(g.c6);
    const float absorb = opaque(g.absorb);
    const uint32_t pre_a = smem_u32(src_pre);
    const int iters = (len + kClusterThreads - 1) / kClusterThreads;

    float pr[CPT], dv[CPT];
    unsigned valid, interior;
    int src_i;
    load_cells<CPT>(g, sl.start, len, src, p_in, div_in, buf0 + nn, pr, dv,
                    valid, interior, src_i);
    for (int j = tid; j < nn; j += kClusterThreads) {
        const int lo = sl.start - nn + j, hi = sl.end + j;
        if (lo >= 0) buf0[j] = p_at_start(g, p_in, src, lo);
        if (hi < g.cells) buf0[nn + len + j] = p_at_start(g, p_in, src, hi);
    }
    if (tid == 0) {
        mbar_init(&bars[0]);
        mbar_init(&bars[1]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    FDTD_MARK(1);
    cluster.sync();  // every block has started, its mbarriers initialised
    FDTD_MARK(3);

    const int substeps = 3 * g.s;
    for (int k = 0; k < substeps; ++k) {
        const int q = (k + 1) & 1;  // the buffer this substep writes
        float* const bq = q ? buf1 : buf0;
        const float* cur = (q ? buf0 : buf1) + nn;
        const bool send = k + 1 < substeps && expect > 0;
        if (k > 0 && k % 3 == 0) {
            cluster_receivers(g, sl, k / 3 - 1, cur, src_pre, out);
            FDTD_MARK(4);
        }
        if (tid == 0 && send) mbar_expect(&bars[q], expect);
        // The cell of this thread that gets the injection, if any.
        const int inj = (k % 3 == 2 && k / 3 + 1 < g.s) ? src_i : -1;
        const uint32_t a = opaque(smem_u32(cur) + 4u * tid);
        const uint32_t a_n = a + 4 * n, a_mn = a - 4 * n;
        const uint32_t a_nn = a + 4 * nn, a_mnn = a - 4 * nn;
        const uint32_t w0 = a - smem_u32(cur) + smem_u32(bq + nn);
        const uint32_t in_mask = opaque(interior), ok_mask = opaque(valid);
        // This buffer's copies in the neighbours: the first nn cells go to
        // the previous block's upper halo, the last nn to the next block's
        // lower halo.
        Remote up(bq, sl.prev_start - nn, sl.start, &bars[q],
                  has_prev ? sl.rank - 1 : sl.rank);
        Remote down(bq, sl.end - nn, sl.start, &bars[q],
                    has_next ? sl.rank + 1 : sl.rank);
        auto cell = [&](int i) {
            const uint32_t o = 4u * kClusterThreads * i;
            const int l = i * kClusterThreads + tid;
            float v = div_cell(pr[i], dv[i], in_mask >> i & 1u, lds(a_nn + o),
                               lds(a_mnn + o), lds(a_n + o), lds(a_mn + o),
                               lds(a + o + 4), lds(a + o - 4), k1, k2, c6,
                               absorb);
            if (i == inj) {
                sts(pre_a, v);
                v = __fadd_rn(v, src[k / 3 + 1]);
            }
            pr[i] = v;
            const bool ok = ok_mask >> i & 1u;
            sts_if(ok, w0 + o, v);
            if (send && has_prev && l < nn) store_async(up.slot + o, v, up.bar);
            if (send && has_next && ok && l >= len - nn) {
                store_async(down.slot + o, v, down.bar);
            }
        };
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            if (runs<CPT>(outside_in<CPT>(j), iters)) cell(outside_in<CPT>(j));
        }
        FDTD_MARK(2);
        __syncthreads();
        if (send) mbar_wait(&bars[q], (k >> 1) & 1);
        FDTD_MARK(3);
    }
    const float* fin = ((substeps & 1) ? buf1 : buf0) + nn;
    cluster_receivers(g, sl, g.s - 1, fin, src_pre, out);
    FDTD_MARK(4);
    store_cells<CPT>(sl.start, len, pr, dv, p_out, div_out);
    FDTD_MARK(7);
    cluster.sync();  // no block leaves while a neighbour may address it
}

// Only the cluster barrier, `syncs` times: what one substep's barrier
// costs at a given cluster size and shared memory, with no stencil work.
__global__ void __launch_bounds__(kClusterThreads, 1)
fdtd_cluster_probe_kernel(int syncs) {
    cg::cluster_group cluster = cg::this_cluster();
    for (int i = 0; i < syncs; ++i) cluster.sync();
}

// ---- the plane route --------------------------------------------------

// Ints from one block's flag to the next: a 128-byte line each.
constexpr int kFlagStride = 32;

// Floats of one plane's slot in the exchange buffer: n^2 cells and the
// padding that the last iteration's loads reach into.
__host__ __device__ __forceinline__ long long plane_stride(int n) {
    return padded(1LL * n * n);
}

// Floats ahead of the plane in a shared-memory buffer (at least n + 1, so
// that the loads of row -1 stay in bounds), and floats of one buffer: the
// lead, the plane, one iteration of 1,024 cells and the lead again.
__host__ __device__ __forceinline__ int plane_lead(int n) {
    return (n + 4) & ~3;
}

__host__ __device__ __forceinline__ int plane_slots(int n) {
    return (2 * plane_lead(n) + n * n + kClusterThreads + 3) & ~3;
}

// Global-memory load and store that bypass L1: the exchange buffer is
// written by other blocks between one substep and the next. The load is
// free to move, as lds() is: its address is rebuilt each substep after
// the barrier that follows the wait.
__device__ __forceinline__ float ldcg(const float* p) {
    float v;
    asm("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p));
    return v;
}

__device__ __forceinline__ void stcg_if(bool ok, float* p, float v) {
    asm volatile(
        "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %0, 0;\n\t"
        "@p st.global.cg.f32 [%1], %2;\n\t}" ::"r"(static_cast<uint32_t>(ok)),
        "l"(p), "f"(v)
        : "memory");
}

__device__ __forceinline__ const float* opaque(const float* p) {
    asm volatile("" : "+l"(p));
    return p;
}

// A block's flag: the number of substeps whose planes it has published.
__device__ __forceinline__ void flag_release(int* f, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(f), "r"(v)
                 : "memory");
}

__device__ __forceinline__ void flag_wait(const int* f, int v) {
    int got;
    do {
        asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                     : "=r"(got)
                     : "l"(f)
                     : "memory");
    } while (got < v);
}

// Divergence form, one block a plane (block b: plane b, n blocks of 1,024
// threads in one cooperative launch). Shared memory: 8 floats (the source
// cell's pre-injection value at 4), then two plane buffers of
// plane_slots(n) floats, cell l of the plane at slot plane_lead(n) + l.
// xch holds two parities of n + 2 slots of plane_stride(n) floats, plane
// b at slot b + 1 (slots 0 and n + 1 are never written: the boundary
// planes' loads from them are discarded); flags, one a block every
// kFlagStride ints. Thread t owns cells l = i * 1024 + t, i < CPT (the
// build of ceil(n^2 / 1024) rounded up to odd; only the last iteration
// that runs is partial: its loads stay in the padding, its stores are
// masked).
template <int CPT>
__global__ void __launch_bounds__(kClusterThreads, 1)
fdtd_div_planes_kernel(Grid g, const float* __restrict__ src,
                       const float* __restrict__ p_in,
                       const float* __restrict__ div_in,
                       float* __restrict__ p_out,
                       float* __restrict__ div_out,
                       float* __restrict__ out, float* xch, int* flags) {
    extern __shared__ __align__(16) float smem[];
    FDTD_MARK(0);
    const int n = g.n, nn = n * n, tid = threadIdx.x;
    const int b = blockIdx.x, blocks = gridDim.x;
    const Slab sl{b, blocks, b * nn, (b + 1) * nn, (b - 1) * nn, nn};
    float* const src_pre = smem + 4;
    float* const buf0 = smem + 8 + plane_lead(n);
    float* const buf1 = buf0 + plane_slots(n);
    const long long stride = plane_stride(n);
    const long long parity = (n + 2LL) * stride;
    const bool has_prev = b > 0, has_next = b + 1 < blocks;
    int* const own_flag = flags + b * kFlagStride;
    const float k1 = opaque(g.k1), k2 = opaque(g.k2), c6 = opaque(g.c6);
    const float absorb = opaque(g.absorb);
    const uint32_t pre_a = smem_u32(src_pre);
    const int iters = (nn + kClusterThreads - 1) / kClusterThreads;

    float pr[CPT], dv[CPT];
    unsigned valid, interior;
    int src_i;
    load_cells<CPT>(g, sl.start, nn, src, p_in, div_in, buf0, pr, dv, valid,
                    interior, src_i);
    // Substep 0 reads the input planes from parity 0.
    float* const pub0 = xch + (b + 1) * stride + tid;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        stcg_if(valid >> i & 1u, pub0 + i * kClusterThreads, pr[i]);
    }
    if (tid == 0) *own_flag = 0;
    FDTD_MARK(1);
    cg::this_grid().sync();  // the flags reset, the input planes published
    FDTD_MARK(3);

    const int substeps = 3 * g.s;
    for (int k = 0; k < substeps; ++k) {
        const int q = (k + 1) & 1;  // the buffer and the parity k writes
        float* const bq = q ? buf1 : buf0;
        const float* cur = q ? buf0 : buf1;
        const bool send = k + 1 < substeps;
        if (k > 0 && k % 3 == 0) {
            cluster_receivers(g, sl, k / 3 - 1, cur, src_pre, out);
            FDTD_MARK(4);
        }
        const int inj = (k % 3 == 2 && k / 3 + 1 < g.s) ? src_i : -1;
        const uint32_t a = opaque(smem_u32(cur) + 4u * tid);
        const uint32_t a_n = a + 4 * n, a_mn = a - 4 * n;
        const uint32_t w0 = a - smem_u32(cur) + smem_u32(bq);
        const uint32_t in_mask = opaque(interior), ok_mask = opaque(valid);
        // The neighbours' planes of substep k - 1 (the next plane at slot
        // b + 2, the previous at b), and this block's slot of parity q.
        const float* const dn =
            opaque(xch + (k & 1) * parity + b * stride + tid);
        const float* const up = dn + 2 * stride;
        float* const pub = xch + q * parity + (b + 1) * stride + tid;
        auto cell = [&](int i) {
            const uint32_t o = 4u * kClusterThreads * i;
            const int og = kClusterThreads * i;
            float v = div_cell(pr[i], dv[i], in_mask >> i & 1u, ldcg(up + og),
                               ldcg(dn + og), lds(a_n + o), lds(a_mn + o),
                               lds(a + o + 4), lds(a + o - 4), k1, k2, c6,
                               absorb);
            if (i == inj) {
                sts(pre_a, v);
                v = __fadd_rn(v, src[k / 3 + 1]);
            }
            pr[i] = v;
            const bool ok = ok_mask >> i & 1u;
            sts_if(ok, w0 + o, v);
            if (send) stcg_if(ok, pub + og, v);
        };
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
            if (runs<CPT>(i, iters)) cell(i);
        }
        FDTD_MARK(2);
        __syncthreads();  // the plane stored, here and in the exchange
        if (send) {
            if (tid == 0) flag_release(own_flag, k + 1);
            if (tid == 0 && has_prev) flag_wait(own_flag - kFlagStride, k + 1);
            if (tid == 32 && has_next) flag_wait(own_flag + kFlagStride, k + 1);
            __syncthreads();
        }
        FDTD_MARK(3);
    }
    const float* fin = (substeps & 1) ? buf1 : buf0;
    cluster_receivers(g, sl, g.s - 1, fin, src_pre, out);
    FDTD_MARK(4);
    store_cells<CPT>(sl.start, nn, pr, dv, p_out, div_out);
    FDTD_MARK(7);
}

// ---- the field form on the plane route ----------------------------------

// The largest n whose plane a build holds (139^2 <= 19 x 1,024 cells).
constexpr int kMaxPlanes = 139;

// The rows of out each block writes, as ops/fdtd3d.py:receiver_csr gives
// them: block b writes rows order[j], j in [start[b], start[b + 1]) (row j
// itself when order is null: the broadcast receiver's plane owns them
// all). Taken as a __grid_constant__ parameter, like Ranges.
struct RcvPlanes {
    int start[kMaxPlanes + 1];
};

// Rows of out for sample smp that block b writes, from its plane's p
// (own: cell l of the plane at own[l]); src_pre holds the source cell's
// value from before the injection of sample smp + 1.
__device__ void plane_receivers(const Grid& g, const RcvPlanes& rcv,
                                const int* order, int b, int smp,
                                const float* own, const float* src_pre,
                                float* out) {
    const bool injected = smp + 1 < g.s;
    const int base = b * g.n * g.n;
    for (int j = rcv.start[b] + threadIdx.x; j < rcv.start[b + 1];
         j += kClusterThreads) {
        const int t = order ? order[j] : j;
        const int cell = g.rcv_rows ? g.rcv_rows[t] : g.rcv_cell;
        const float v = injected && cell == g.src_cell ? *src_pre
                                                       : own[cell - base];
        out[static_cast<long long>(t) * g.s + smp] = __fmul_rn(v, g.out_scale);
    }
}

// Field form, one block a plane (block b: plane b, n blocks of 1,024
// threads in one cooperative launch), the exchange, flags and layout of
// the divergence form's plane kernel. Thread t owns cells l = i * 1024 +
// t, i < CPT, of the plane (y = l / n, z = l % n): their p and lower x
// face vx[b, y, z] in registers (each face's one owner updates it), and a
// replica of the face above in x, vx[b + 1, y, z], whose owner lies in
// the next plane. The replica is updated as face(vx, p[b + 1], p[b]), the
// owner's operands in the owner's order, so it holds the owner's bits
// with no hand-off of faces: only p crosses blocks. The lower and upper
// faces in y and z belong to threads of the same plane; two layouts keep
// them:
//   * kRegFaces (up to kRegFacesMaxCpt cells a thread): each thread keeps
//     vy[b, y, z], vz[b, y, z] and replicas of vy[b, y + 1, z] and
//     vz[b, y, z + 1] in registers (seven floats a cell); p alone lives in
//     shared memory, in two buffers; one phase a substep.
//   * otherwise vy and vz live in shared memory (one buffer each, cell l
//     at slot plane_lead(n) + l like p) and p in one buffer: a substep
//     updates the faces from p and stores them, meets a __syncthreads,
//     then reads the upper faces and stores p over itself (no thread
//     reads p in that phase). Three floats a cell in registers, three
//     planes in shared memory: room 128 fits.
// Every replica is updated on all of its plane's cells, as its owner
// updates its face, not only where it is read (the interior): the owner of
// vx[b + 1] updates it on every (y, z) while b + 1 <= n - 1. The faces no
// cell owns (vx[n], vy[:, n], vz[:, :, n]) and those at index 0 are never
// updated: they go to the outputs as they came in. kWait and kExchange
// false are measurements (tools/fdtd_stages): no waits for the
// neighbours' flags; no exchange either (the +-n^2 neighbours read from
// the block's own plane).
template <int CPT, bool kRegFaces, bool kWait = true, bool kExchange = true>
__global__ void __launch_bounds__(kClusterThreads, 1)
fdtd_field_planes_kernel(Grid g, const __grid_constant__ RcvPlanes rcv,
                         const int* __restrict__ order,
                         const float* __restrict__ src,
                         const float* __restrict__ p_in,
                         const float* __restrict__ vx_in,
                         const float* __restrict__ vy_in,
                         const float* __restrict__ vz_in,
                         float* __restrict__ p_out,
                         float* __restrict__ vx_out,
                         float* __restrict__ vy_out,
                         float* __restrict__ vz_out, float* __restrict__ out,
                         float* xch, int* flags) {
    extern __shared__ __align__(16) float smem[];
    FDTD_MARK(0);
    constexpr int R = kRegFaces ? CPT : 1;  // y and z faces in registers
    const int n = g.n, nn = n * n, tid = threadIdx.x;
    const int b = blockIdx.x, base = b * nn;
    const int slots = plane_slots(n);
    float* const src_pre = smem + 4;
    float* const buf0 = smem + 8 + plane_lead(n);
    float* const buf1 = kRegFaces ? buf0 + slots : buf0;
    float* const fy = buf1 + slots;  // without kRegFaces: vy, vz of the plane
    float* const fz = fy + slots;
    const long long stride = plane_stride(n);
    const long long parity = (n + 2LL) * stride;
    const bool has_prev = b > 0, has_next = b + 1 < n;
    int* const own_flag = flags + b * kFlagStride;
    const float k1 = opaque(g.k1), k2 = opaque(g.k2);
    const float absorb = opaque(g.absorb);
    const uint32_t pre_a = smem_u32(src_pre);
    const int iters = (nn + kClusterThreads - 1) / kClusterThreads;

    // The prologue: the fields of the thread's cells, the faces no cell
    // owns copied through, the input plane published, the flag reset.
    float pr[CPT], vx0[CPT], vx1[CPT], vy0[R], vz0[R], vy1[R], vz1[R];
    unsigned valid = 0, interior = 0, ylo = 0, zlo = 0;
    int src_i = -1;
    float* const pub0 = xch + (b + 1) * stride + tid;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const int l = i * kClusterThreads + tid;
        const int r = i % R;
        pr[i] = vx0[i] = vx1[i] = 0.f;
        vy0[r] = vz0[r] = vy1[r] = vz1[r] = 0.f;
        if (l < nn) {
            const int c = base + l, y = l / n, z = l % n;
            const int fyi = c + b * n, fzi = c + b * n + y;  // vy, vz [b, y, z]
            valid |= 1u << i;
            if (!on_boundary(b, y, z, n)) interior |= 1u << i;
            if (y >= 1) ylo |= 1u << i;
            if (z >= 1) zlo |= 1u << i;
            if (c == g.src_cell) src_i = i;
            pr[i] = p_at_start(g, p_in, src, c);
            buf0[l] = pr[i];
            stcg_if(true, pub0 + i * kClusterThreads, pr[i]);
            vx0[i] = vx_in[c];
            vx1[i] = vx_in[c + nn];
            if (kRegFaces) {
                vy0[r] = vy_in[fyi];
                vz0[r] = vz_in[fzi];
                vy1[r] = vy_in[fyi + n];
                vz1[r] = vz_in[fzi + 1];
            } else {
                fy[l] = vy_in[fyi];
                fz[l] = vz_in[fzi];
            }
        }
    }
    for (int j = tid; j < n; j += kClusterThreads) {
        const int vy_top = (b * (n + 1) + n) * n + j;  // vy[b, n, j]
        const int vz_top = (b * n + j) * (n + 1) + n;  // vz[b, j, n]
        vy_out[vy_top] = vy_in[vy_top];
        vz_out[vz_top] = vz_in[vz_top];
    }
    if (!has_next) {
        for (int l = tid; l < nn; l += kClusterThreads) {
            vx_out[n * nn + l] = vx_in[n * nn + l];  // vx[n]
        }
    }
    if (tid == 0) *own_flag = 0;
    FDTD_MARK(1);
    cg::this_grid().sync();  // the flags reset, the input planes published
    FDTD_MARK(3);

    const int substeps = 3 * g.s;
    for (int k = 0; k < substeps; ++k) {
        const int q = (k + 1) & 1;  // the buffer and the parity k writes
        float* const bq = q ? buf1 : buf0;
        const float* cur = q ? buf0 : buf1;
        const bool send = k + 1 < substeps;
        if (k > 0 && k % 3 == 0) {
            plane_receivers(g, rcv, order, b, k / 3 - 1, cur, src_pre, out);
            FDTD_MARK(4);
        }
        const int inj = (k % 3 == 2 && k / 3 + 1 < g.s) ? src_i : -1;
        const uint32_t a = opaque(smem_u32(cur) + 4u * tid);
        const uint32_t a_n = a + 4 * n, a_mn = a - 4 * n;
        const uint32_t w0 = a - smem_u32(cur) + smem_u32(bq);
        const uint32_t ay = a - smem_u32(cur) + smem_u32(fy);
        const uint32_t az = a - smem_u32(cur) + smem_u32(fz);
        const uint32_t in_mask = opaque(interior), ok_mask = opaque(valid);
        const uint32_t y_mask = opaque(ylo), z_mask = opaque(zlo);
        // The neighbours' planes of substep k - 1 (the next plane at slot
        // b + 2, the previous at b), and this block's slot of parity q.
        const float* const dn =
            opaque(xch + (k & 1) * parity + b * stride + tid);
        const float* const up = dn + 2 * stride;
        float* const pub = xch + q * parity + (b + 1) * stride + tid;
        // The faces of cell i from the p of substep k - 1 (without
        // kRegFaces, vy and vz read and stored in shared memory).
        auto faces = [&](int i) {
            const uint32_t o = 4u * kClusterThreads * i;
            const int og = kClusterThreads * i;
            const int r = i % R;
            const float pc = pr[i];
            const float pdn = kExchange ? ldcg(dn + og) : lds(a + o);
            const float pup = kExchange ? ldcg(up + og) : lds(a + o);
            if (has_prev) vx0[i] = face(vx0[i], pc, pdn, k1);
            if (has_next) vx1[i] = face(vx1[i], pup, pc, k1);
            const float oy = kRegFaces ? vy0[r] : lds(ay + o);
            const float oz = kRegFaces ? vz0[r] : lds(az + o);
            const float ny = y_mask >> i & 1u
                                 ? face(oy, pc, lds(a_mn + o), k1) : oy;
            const float nz = z_mask >> i & 1u
                                 ? face(oz, pc, lds(a + o - 4), k1) : oz;
            if (kRegFaces) {
                vy0[r] = ny;
                vz0[r] = nz;
                vy1[r] = face(vy1[r], lds(a_n + o), pc, k1);
                vz1[r] = face(vz1[r], lds(a + o + 4), pc, k1);
            } else {
                const bool ok = ok_mask >> i & 1u;
                sts_if(ok, ay + o, ny);
                sts_if(ok, az + o, nz);
            }
        };
        // p of cell i from its faces, stored here and in the exchange.
        auto pressure = [&](int i) {
            const uint32_t o = 4u * kClusterThreads * i;
            const int og = kClusterThreads * i;
            const int r = i % R;
            const float pc = pr[i];
            const float ly = kRegFaces ? vy0[r] : lds(ay + o);
            const float lz = kRegFaces ? vz0[r] : lds(az + o);
            const float uy = kRegFaces ? vy1[r] : lds(ay + o + 4 * n);
            const float uz = kRegFaces ? vz1[r] : lds(az + o + 4);
            const float d = __fadd_rn(
                __fadd_rn(__fsub_rn(vx1[i], vx0[i]), __fsub_rn(uy, ly)),
                __fsub_rn(uz, lz));
            const float vi = __fsub_rn(pc, __fmul_rn(k2, d));
            const float vb = __fmul_rn(pc, absorb);
            float v = in_mask >> i & 1u ? vi : vb;
            if (i == inj) {
                sts(pre_a, v);
                v = __fadd_rn(v, src[k / 3 + 1]);
            }
            pr[i] = v;
            const bool ok = ok_mask >> i & 1u;
            sts_if(ok, w0 + o, v);
            if (kExchange && send) stcg_if(ok, pub + og, v);
        };
        if (kRegFaces) {
#pragma unroll
            for (int i = 0; i < CPT; ++i) {
                if (runs<CPT>(i, iters)) {
                    faces(i);
                    pressure(i);
                }
            }
            FDTD_MARK(2);
        } else {
#pragma unroll
            for (int i = 0; i < CPT; ++i) {
                if (runs<CPT>(i, iters)) faces(i);
            }
            FDTD_MARK(2);
            __syncthreads();  // p read, the plane's new vy and vz stored
#pragma unroll
            for (int i = 0; i < CPT; ++i) {
                if (runs<CPT>(i, iters)) pressure(i);
            }
            FDTD_MARK(6);
        }
        __syncthreads();  // the plane stored, here and in the exchange
        if (send) {
            if (tid == 0) flag_release(own_flag, k + 1);
            if (kWait && tid == 0 && has_prev) {
                flag_wait(own_flag - kFlagStride, k + 1);
            }
            if (kWait && tid == 32 && has_next) {
                flag_wait(own_flag + kFlagStride, k + 1);
            }
            __syncthreads();
        }
        FDTD_MARK(3);
    }
    const float* fin = (substeps & 1) ? buf1 : buf0;
    plane_receivers(g, rcv, order, b, g.s - 1, fin, src_pre, out);
    FDTD_MARK(4);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const int l = i * kClusterThreads + tid;
        if (l < nn) {
            const int c = base + l, y = l / n, r = i % R;
            p_out[c] = pr[i];
            vx_out[c] = vx0[i];
            vy_out[c + b * n] = kRegFaces ? vy0[r] : fy[l];
            vz_out[c + b * n + y] = kRegFaces ? vz0[r] : fz[l];
        }
    }
    FDTD_MARK(7);
}

// The build a range of at most `cap` cells takes: its iterations of 1,024
// cells, rounded up to odd.
int cells_per_thread(long long cap) {
    return static_cast<int>((cap + kClusterThreads - 1) / kClusterThreads | 1);
}

// Reads `blocks` ranges from starts (blocks + 1 entries) into *r, if they
// can carry an n^3 grid: they cover it in order, each of at least n^2
// cells (so a neighbour lies in an adjacent range), balanced within one
// cell (so a build guards only its last two iterations).
bool cluster_ranges(int n, const int* starts, int blocks, Ranges* r) {
    if (n < 3 || n > 1024 || starts == nullptr || blocks < 1 ||
        blocks > kMaxClusterBlocks) {
        return false;
    }
    const long long nn = 1LL * n * n, cells = nn * n;
    if (starts[0] != 0 || starts[blocks] != cells) return false;
    long long shortest = cells, longest = 0;
    for (int b = 0; b < blocks; ++b) {
        const long long len = 1LL * starts[b + 1] - starts[b];
        if (len < nn) return false;
        shortest = len < shortest ? len : shortest;
        longest = len > longest ? len : longest;
    }
    if (longest - shortest > 1) return false;
    *r = Ranges{};
    for (int b = 0; b <= blocks; ++b) r->start[b] = starts[b];
    r->cap = static_cast<int>(longest);
    return true;
}

// Dynamic shared memory a block of the cluster kernel takes for ranges of
// at most `cap` cells (ops/fdtd3d.py:cluster_smem_bytes): 8 floats (two
// mbarriers, the pre-injection value), then two p buffers of the range
// with an n^2 halo on each side.
long long div_cluster_smem(int n, int cap) {
    return 4 * (8LL + 2 * padded(cap + 2LL * n * n));
}

using DivClusterKernel = void (*)(Grid, Ranges, const float*, const float*,
                                  const float*, float*, float*, float*);

// The builds, one for each odd count of cells a thread; null above them.
#define FDTD_BUILDS(kernel)                                              \
    switch (cpt) {                                                       \
        case 1: return kernel<1>;                                        \
        case 3: return kernel<3>;                                        \
        case 5: return kernel<5>;                                        \
        case 7: return kernel<7>;                                        \
        case 9: return kernel<9>;                                        \
        case 11: return kernel<11>;                                      \
        case 13: return kernel<13>;                                      \
        case 15: return kernel<15>;                                      \
        case 17: return kernel<17>;                                      \
        case 19: return kernel<19>;                                      \
        default: return nullptr;                                         \
    }

DivClusterKernel div_cluster_kernel(int cpt) {
    FDTD_BUILDS(fdtd_div_cluster_kernel)
}

using DivPlanesKernel = void (*)(Grid, const float*, const float*,
                                 const float*, float*, float*, float*, float*,
                                 int*);

// The plane kernel's builds, as the cluster kernel's.
DivPlanesKernel div_planes_kernel(int cpt) {
    FDTD_BUILDS(fdtd_div_planes_kernel)
}
#undef FDTD_BUILDS

// Dynamic shared memory a block of the plane kernel takes for an n^3 grid
// (ops/fdtd3d.py:planes_smem_bytes): 8 floats, then two plane buffers.
long long div_planes_smem(int n) { return 4 * (8LL + 2 * plane_slots(n)); }

// Whether starts (blocks + 1 ints) are the plane route's ranges of an n^3
// grid: block b owns plane b, [b n^2, (b + 1) n^2).
bool plane_ranges(int n, const int* starts, int blocks) {
    if (n < 3 || n > 1024 || starts == nullptr || blocks != n) return false;
    for (int b = 0; b <= blocks; ++b) {
        if (starts[b] != b * n * n) return false;
    }
    return true;
}

// Blocks of `threads` threads of `kernel` with `smem` bytes of dynamic
// shared memory each that the current device holds at once (after
// setting the kernel's shared-memory attribute); 0 with *err set when it
// cannot launch them cooperatively.
int coresident_blocks(const void* kernel, int threads, long long smem,
                      cudaError_t* err) {
    int dev = 0, sms = 0, coop = 0, optin = 0, per_sm = 0;
    *err = cudaGetDevice(&dev);
    if (*err == cudaSuccess) {
        *err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    }
    if (*err == cudaSuccess) {
        *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (*err == cudaSuccess) {
        *err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (*err != cudaSuccess) return 0;
    if (smem < 0 || smem > optin) {
        *err = cudaErrorInvalidValue;
        return 0;
    }
    *err = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
    if (*err == cudaSuccess) {
        *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, threads, static_cast<size_t>(smem));
    }
    if (*err != cudaSuccess) return 0;
    if (!coop || per_sm < 1) {
        *err = cudaErrorCooperativeLaunchTooLarge;
        return 0;
    }
    return per_sm * sms;
}

// A one-cluster launch of `kernel`: `blocks` blocks of 1,024 threads,
// `smem` bytes of dynamic shared memory each. Sets the kernel's
// attributes (the opt-in shared memory; a non-portable size above 8).
cudaError_t cluster_config(const void* kernel, int blocks, long long smem,
                           cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err != cudaSuccess) return err;
    if (smem < 0 || smem > optin) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess && blocks > 8) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(blocks);
    cfg->blockDim = dim3(kClusterThreads);
    cfg->dynamicSmemBytes = static_cast<size_t>(smem);
    cfg->stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = blocks;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = 1;
    return err;
}

Grid make_grid(int n, int s, int src_cell, int tracks, int rcv_cell,
               const int* rcv_rows, float k1, float k2, float c6,
               float absorb, float out_scale) {
    Grid g;
    g.n = n;
    g.cells = n * n * n;
    g.s = s;
    g.src_cell = src_cell;
    g.tracks = tracks;
    g.rcv_cell = rcv_cell;
    g.rcv_rows = rcv_rows;
    g.k1 = k1;
    g.k2 = k2;
    g.c6 = c6;
    g.absorb = absorb;
    g.out_scale = out_scale;
    return g;
}

bool bad_shape(int n, int s, int tracks, int src_cell) {
    return n < 3 || n > 1024 || s <= 0 || tracks <= 0 || src_cell < 0 ||
           src_cell >= n * n * n;
}

using FieldPlanesKernel = void (*)(Grid, RcvPlanes, const int*, const float*,
                                   const float*, const float*, const float*,
                                   const float*, float*, float*, float*,
                                   float*, float*, float*, int*);

// The field plane kernel keeps the upper faces' replicas in registers
// (kRegFaces) up to this many cells a thread, and vy and vz in shared
// memory above (ops/fdtd3d.py:FIELD_REG_FACES_MAX_CPT).
constexpr int kRegFacesMaxCpt = 7;

// The field plane kernel's builds, one for each odd count of cells a
// thread; null above them.
FieldPlanesKernel field_planes_kernel(int cpt) {
#define FDTD_FIELD_BUILD(c) \
    case c: return fdtd_field_planes_kernel<c, (c <= kRegFacesMaxCpt)>;
    switch (cpt) {
        FDTD_FIELD_BUILD(1)
        FDTD_FIELD_BUILD(3)
        FDTD_FIELD_BUILD(5)
        FDTD_FIELD_BUILD(7)
        FDTD_FIELD_BUILD(9)
        FDTD_FIELD_BUILD(11)
        FDTD_FIELD_BUILD(13)
        FDTD_FIELD_BUILD(15)
        FDTD_FIELD_BUILD(17)
        default: return nullptr;
    }
#undef FDTD_FIELD_BUILD
}

// Dynamic shared memory a block of a field plane build takes for an n^3
// grid (ops/fdtd3d.py:planes_smem_bytes): 8 floats, then two p buffers
// where the build keeps the faces in registers, else one p buffer, vy
// and vz.
long long field_planes_smem(int n, bool reg_faces) {
    return 4 * (8LL + (reg_faces ? 2 : 3) * plane_slots(n));
}

// The rows of out each block writes: from rcv_starts (n + 1 ints, host
// memory, from 0 to `tracks` in order) for per-track receivers; for the
// broadcast receiver (rcv_starts null), every row to its cell's plane.
bool receiver_planes(int n, int tracks, int rcv_cell, const int* rcv_starts,
                     RcvPlanes* r) {
    if (n > kMaxPlanes) return false;
    *r = RcvPlanes{};
    if (rcv_starts == nullptr) {
        if (rcv_cell < 0 || rcv_cell >= n * n * n) return false;
        for (int b = 0; b <= n; ++b) {
            r->start[b] = b <= rcv_cell / (n * n) ? 0 : tracks;
        }
        return true;
    }
    if (rcv_starts[0] != 0 || rcv_starts[n] != tracks) return false;
    for (int b = 0; b <= n; ++b) {
        if (b > 0 && rcv_starts[b] < rcv_starts[b - 1]) return false;
        r->start[b] = rcv_starts[b];
    }
    return true;
}

// One cooperative launch of a field plane build (`kernel`, `smem` bytes a
// block) on the schedule's planes; the arguments as
// fdtd_field_planes_launch's. Refuses (cudaErrorInvalidValue) ranges that
// are not the planes or rows that do not cover out, and
// (cudaErrorCooperativeLaunchTooLarge) a grid the card cannot hold at
// once, before launching anything.
int field_planes_launch(FieldPlanesKernel kernel, long long smem,
                        const float* src, const float* p_in,
                        const float* vx_in, const float* vy_in,
                        const float* vz_in, float* p_out, float* vx_out,
                        float* vy_out, float* vz_out, float* out, float* xch,
                        int* flags, const int* rcv_rows, const int* order,
                        const int* rcv_starts, int n, int s, int src_cell,
                        int tracks, int rcv_cell, float k1, float k2,
                        float absorb, float out_scale, const int* starts,
                        int blocks, cudaStream_t stream) {
    RcvPlanes rcv;
    const bool per_track = rcv_rows != nullptr;
    if (bad_shape(n, s, tracks, src_cell) ||
        !plane_ranges(n, starts, blocks) || kernel == nullptr ||
        per_track != (order != nullptr) ||
        per_track != (rcv_starts != nullptr) ||
        !receiver_planes(n, tracks, rcv_cell, rcv_starts, &rcv)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err;
    const int fit =
        coresident_blocks((const void*)kernel, kClusterThreads, smem, &err);
    if (fit == 0) return static_cast<int>(err);
    if (fit < blocks) {
        return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    }
    Grid g = make_grid(n, s, src_cell, tracks, rcv_cell, rcv_rows, k1, k2,
                       0.f, absorb, out_scale);
    void* args[] = {&g,     &rcv,   &order,  &src,    &p_in,   &vx_in,
                    &vy_in, &vz_in, &p_out,  &vx_out, &vy_out, &vz_out,
                    &out,   &xch,   &flags};
    err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                      dim3(kClusterThreads), args,
                                      static_cast<size_t>(smem), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Plane route, divergence form: one cooperative launch of `blocks` = n
// blocks, block b owning plane b ([starts[b], starts[b + 1]) = [b n^2,
// (b + 1) n^2); starts: blocks + 1 ints, host memory). src (s,), p_in and
// div_in (n^3,) read only; p_out and div_out (n^3,) receive p' and div';
// out (tracks, s), every row read from rcv_cell; xch (2 (n + 2)
// plane_stride(n) floats) and flags (n kFlagStride ints) scratch, neither
// read before the kernel writes it. Returns the launch's error (0 on
// success): cudaErrorInvalidValue when the ranges are not the planes or
// no build takes n^2 cells a block, cudaErrorCooperativeLaunchTooLarge
// when the card cannot hold the blocks at once.
int fdtd_div_planes_launch(const float* src, const float* p_in,
                           const float* div_in, float* p_out, float* div_out,
                           float* out, float* xch, int* flags, int n, int s,
                           int src_cell, int tracks, int rcv_cell, float k1,
                           float k2, float c6, float absorb, float out_scale,
                           const int* starts, int blocks, void* stream) {
    if (bad_shape(n, s, tracks, src_cell) ||
        !plane_ranges(n, starts, blocks)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const DivPlanesKernel kernel =
        div_planes_kernel(cells_per_thread(1LL * n * n));
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const long long smem = div_planes_smem(n);
    cudaError_t err;
    const int fit =
        coresident_blocks((const void*)kernel, kClusterThreads, smem, &err);
    if (fit == 0) return static_cast<int>(err);
    if (fit < blocks) {
        return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    }
    Grid g = make_grid(n, s, src_cell, tracks, rcv_cell, nullptr, k1, k2, c6,
                       absorb, out_scale);
    void* args[] = {&g,   &src, &p_in, &div_in, &p_out,
                    &div_out, &out, &xch, &flags};
    err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                      dim3(kClusterThreads), args,
                                      static_cast<size_t>(smem),
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// Plane route, field form: one cooperative launch of `blocks` = n blocks,
// block b owning plane b (starts as fdtd_div_planes_launch's). src (s,),
// p_in (n^3,), vx_in (n+1, n, n), vy_in (n, n+1, n), vz_in (n, n, n+1)
// read only; p_out, vx_out, vy_out, vz_out receive the fields; out
// (tracks, s); xch (2 (n + 2) plane_stride(n) floats) and flags (n
// kFlagStride ints) scratch, neither read before the kernel writes it.
// Per-track receivers: rcv_rows (tracks,) flat cells and order (tracks,)
// the rows by plane, both device memory, and rcv_starts (n + 1 ints, host
// memory): block b writes rows order[j], j in [rcv_starts[b],
// rcv_starts[b + 1]), each of whose cells lies in plane b
// (ops/fdtd3d.py:receiver_csr). All three null: every row reads
// rcv_cell. Returns the launch's error (0 on success):
// cudaErrorInvalidValue when the ranges are not the planes, the rows do
// not cover out or no build takes n^2 cells a block,
// cudaErrorCooperativeLaunchTooLarge when the card cannot hold the blocks
// at once.
int fdtd_field_planes_launch(const float* src, const float* p_in,
                             const float* vx_in, const float* vy_in,
                             const float* vz_in, float* p_out, float* vx_out,
                             float* vy_out, float* vz_out, float* out,
                             float* xch, int* flags, const int* rcv_rows,
                             const int* order, const int* rcv_starts, int n,
                             int s, int src_cell, int tracks, int rcv_cell,
                             float k1, float k2, float absorb,
                             float out_scale, const int* starts, int blocks,
                             void* stream) {
    if (n < 3 || n > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
    const int cpt = cells_per_thread(1LL * n * n);
    return field_planes_launch(
        field_planes_kernel(cpt), field_planes_smem(n, cpt <= kRegFacesMaxCpt),
        src, p_in, vx_in, vy_in, vz_in, p_out, vx_out, vy_out, vz_out, out,
        xch, flags, rcv_rows, order, rcv_starts, n, s, src_cell, tracks,
        rcv_cell, k1, k2, absorb, out_scale, starts, blocks,
        static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory a block of the field plane kernel takes for an
// n^3 grid, or -1 when no build takes n^2 cells a block.
long long fdtd_field_planes_smem(int n) {
    if (n < 3 || n > kMaxPlanes) return -1;
    const int cpt = cells_per_thread(1LL * n * n);
    if (field_planes_kernel(cpt) == nullptr) return -1;
    return field_planes_smem(n, cpt <= kRegFacesMaxCpt);
}

// Blocks of the field plane kernel for an n^3 grid that the card holds at
// once (the launch needs n); the negated CUDA error when the query fails.
int fdtd_field_planes_capacity(int n) {
    const long long smem = fdtd_field_planes_smem(n);
    if (smem < 0) return -static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    const int fit = coresident_blocks(
        (const void*)field_planes_kernel(cells_per_thread(1LL * n * n)),
        kClusterThreads, smem, &err);
    return fit > 0 ? fit : -static_cast<int>(err);
}

// The dynamic shared memory a block of the plane kernel takes for an n^3
// grid, or -1 when no build takes n^2 cells a block.
long long fdtd_planes_smem(int n) {
    if (n < 3 || n > 1024 ||
        div_planes_kernel(cells_per_thread(1LL * n * n)) == nullptr) {
        return -1;
    }
    return div_planes_smem(n);
}

// Blocks of the plane kernel for an n^3 grid that the card holds at once
// (the launch needs n); the negated CUDA error when the query fails.
int fdtd_planes_capacity(int n) {
    const long long smem = fdtd_planes_smem(n);
    if (smem < 0) return -static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    const int fit = coresident_blocks(
        (const void*)div_planes_kernel(cells_per_thread(1LL * n * n)),
        kClusterThreads, smem, &err);
    return fit > 0 ? fit : -static_cast<int>(err);
}

// Cluster route, divergence form: one cluster of `blocks` blocks carries
// the whole n^3 grid in its shared memory, block r the flat cells
// [starts[r], starts[r + 1]) (starts: blocks + 1 ints, host memory). src
// (s,), p_in and div_in (n^3,) read only; p_out and div_out (n^3,)
// receive p' and div'; out (tracks, s), every row read from rcv_cell.
// Returns the launch's error (0 on success); cudaErrorInvalidValue when
// the ranges cannot carry the grid (cluster_ranges, no build) or the card
// lacks the shared memory.
int fdtd_div_cluster_launch(const float* src, const float* p_in,
                            const float* div_in, float* p_out, float* div_out,
                            float* out, int n, int s, int src_cell, int tracks,
                            int rcv_cell, float k1, float k2, float c6,
                            float absorb, float out_scale, const int* starts,
                            int blocks, void* stream) {
    Ranges r;
    if (bad_shape(n, s, tracks, src_cell) ||
        !cluster_ranges(n, starts, blocks, &r)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const DivClusterKernel kernel = div_cluster_kernel(cells_per_thread(r.cap));
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_config((const void*)kernel, blocks,
                                     div_cluster_smem(n, r.cap),
                                     static_cast<cudaStream_t>(stream), &cfg,
                                     &attr);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Grid g = make_grid(n, s, src_cell, tracks, rcv_cell, nullptr, k1,
                             k2, c6, absorb, out_scale);
    err = cudaLaunchKernelEx(&cfg, kernel, g, r, src, p_in, div_in, p_out,
                             div_out, out);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block of the cluster kernel takes for an
// n^3 grid on the ranges of fdtd_div_cluster_launch, or -1 when they
// cannot carry it.
long long fdtd_cluster_smem(int n, const int* starts, int blocks) {
    Ranges r;
    if (!cluster_ranges(n, starts, blocks, &r) ||
        div_cluster_kernel(cells_per_thread(r.cap)) == nullptr) {
        return -1;
    }
    return div_cluster_smem(n, r.cap);
}

// Clusters of the cluster kernel for an n^3 grid on those ranges that the
// card can hold at once (cudaOccupancyMaxActiveClusters); the negated
// CUDA error when the query fails.
int fdtd_cluster_occupancy(int n, const int* starts, int blocks) {
    const long long smem = fdtd_cluster_smem(n, starts, blocks);
    if (smem < 0) return -static_cast<int>(cudaErrorInvalidValue);
    Ranges r;
    cluster_ranges(n, starts, blocks, &r);
    const void* kernel = (const void*)div_cluster_kernel(cells_per_thread(r.cap));
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_config(kernel, blocks, smem, nullptr, &cfg, &attr);
    int clusters = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    }
    return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// `syncs` cluster barriers alone, in one cluster of `blocks` blocks of
// 1,024 threads with `smem` bytes of dynamic shared memory each. Returns
// the launch's error (0 on success).
int fdtd_cluster_probe_launch(int syncs, int blocks, int smem, void* stream) {
    if (syncs < 0 || blocks < 1 || blocks > kMaxClusterBlocks) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_config((const void*)fdtd_cluster_probe_kernel,
                                     blocks, smem,
                                     static_cast<cudaStream_t>(stream), &cfg,
                                     &attr);
    if (err == cudaSuccess) {
        err = cudaLaunchKernelEx(&cfg, fdtd_cluster_probe_kernel, syncs);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// Clusters of the barrier probe (`blocks` blocks, `smem` bytes each) that
// the card can hold at once: 0 when such a cluster cannot be scheduled;
// the negated CUDA error when the query fails.
int fdtd_cluster_probe_occupancy(int blocks, int smem) {
    if (blocks < 1 || blocks > kMaxClusterBlocks) {
        return -static_cast<int>(cudaErrorInvalidValue);
    }
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_config((const void*)fdtd_cluster_probe_kernel,
                                     blocks, smem, nullptr, &cfg, &attr);
    int clusters = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveClusters(
            &clusters, (const void*)fdtd_cluster_probe_kernel, &cfg);
    }
    return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

}  // extern "C"
