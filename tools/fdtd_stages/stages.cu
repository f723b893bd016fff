// Measurements behind PERF.md's account of the FDTD3D redesign
// (csrc/fdtd3d.cu): the shipped file is included whole, so one library
// holds the divergence form's cluster kernel, the cooperative kernels and
// the grid-barrier and cluster-barrier probes, beside three designs that
// ship in no kernel:
//
// * barrier_div_launch: the first cluster design of the divergence form
//   (scalar stores into the neighbours' halos, a cluster barrier a
//   substep);
// * no_handoff_div_launch: the shipped cluster kernel with its hand-offs
//   to the neighbours and the waits for them left out (wrong results; a
//   timing of what the exchange costs);
// * two_phase_field_launch: a cluster design of the field form (p, vx,
//   vy, vz single-buffered in shared memory, faces then p, two hand-offs
//   a substep), with its hand-offs or without them;
// * old_coop_div_launch: the grid-stride cooperative divergence kernel
//   that the plane kernel replaced (the grid-sync kernel, verbatim: p and
//   div in device memory, a cg::grid sync a substep), for rooms 66-128;
// * planes_variant_launch: the shipped plane kernel without its waits for
//   the neighbours' flags (the exchange still stored and loaded; wrong
//   results: a timing of what the waits cost), or without the exchange
//   too (the +-n^2 neighbours read from the block's own plane: a timing of
//   the stencil alone on n SMs); or, right, with each cell's in-plane
//   pair sums (y and z) of the next substep taken while the block waits
//   for its neighbours' flags (two more floats a cell in registers);
// * planes_pair_launch: the plane kernel on thread-block clusters of two
//   planes: the partner's plane read from its shared memory (ld
//   .shared::cluster), only the other neighbour's through L2, so a block
//   loads one plane from L2 a substep instead of two.
// * field_planes_variant_launch: the field form's plane kernel in the
//   layout the route does not ship at a room, and without its waits or
//   its exchange (wrong results: timings);
// * old_field_launch: the field form's grid-stride cooperative kernel
//   that the plane kernel replaced (verbatim: p and the velocities in
//   device memory, a cg::grid sync a substep), and
//   fdtd_sync_probe_launch, that grid barrier alone.
//
// run.py (beside this file) builds it twice with nvcc: plain (with
// -Xptxas -v: registers, shared memory and spills) and -DFDTD_PROFILE,
// where the FDTD_MARK hooks become clock64() phase sums per warp
// (fdtd_prof_set hands over the buffer). The designs take the ranges as
// fdtd_div_cluster_launch does.
//
// Nothing of the port loads this file.

#include <cuda_runtime.h>

#ifdef FDTD_PROFILE
// 8 int64 a warp, block-major: [0] the warp's total cycles, [q] the
// cycles up to mark q since the mark before (1 prologue, 2 stencil or
// faces, 3 the wait for the neighbours' hand-offs, 4 receivers, 6 the
// field form's p update, 7 epilogue).
__device__ long long* g_fdtd_prof;

__device__ __forceinline__ void fdtd_mark(int q) {
    __shared__ long long last[32];
    __shared__ long long sums[32][8];
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
        long long* dst = g_fdtd_prof + (static_cast<long long>(blockIdx.x) *
                                        (blockDim.x >> 5) + warp) * 8;
        dst[0] = now - sums[warp][0];
        for (int i = 1; i < 8; ++i) dst[i] = sums[warp][i];
    }
}
#define FDTD_MARK(q) fdtd_mark(q)
#endif

#include "../../gpuaudiobench_tpu_torch/csrc/fdtd3d.cu"

namespace {

#define REMOTE_STORE(ptr, v) (*(ptr) = (v))

// The first cluster design of the divergence form, measured and replaced:
// the same ranges, registers and halos, but each edge cell's owner stores
// it into the neighbour's halo with a scalar st to distributed shared
// memory, and every substep ends in a cluster barrier (cg::cluster_group
// ::sync) that orders those stores. Shared memory: two p buffers of
// [nn | range | nn] and the pre-injection value.
template <int CPT>
__global__ void __launch_bounds__(kClusterThreads, 1)
barrier_div_kernel(Grid g, const __grid_constant__ Ranges ranges,
                   const float* __restrict__ src,
                   const float* __restrict__ p_in,
                   const float* __restrict__ div_in,
                   float* __restrict__ p_out, float* __restrict__ div_out,
                   float* __restrict__ out) {
    extern __shared__ __align__(16) float smem1[];
    cg::cluster_group cluster = cg::this_cluster();
    const int n = g.n, nn = n * n, tid = threadIdx.x;
    const Slab sl = make_slab(ranges);
    const int len = sl.end - sl.start;
    const int plen = sl.start - sl.prev_start;
    const int w = sl.cap + 2 * nn;
    float* const buf0 = smem1;
    float* const buf1 = smem1 + w;
    float* const src_pre = smem1 + 2 * w;
    const bool has_prev = sl.rank > 0, has_next = sl.rank + 1 < sl.blocks;

    float pr[CPT], dv[CPT];
    unsigned interior = 0;
    int src_i = -1;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const int l = i * kClusterThreads + tid;
        pr[i] = dv[i] = 0.f;
        if (l < len) {
            const int c = sl.start + l;
            const int x = c / nn, y = (c / n) % n, z = c % n;
            pr[i] = p_at_start(g, p_in, src, c);
            buf0[nn + l] = pr[i];
            if (c == g.src_cell) src_i = i;
            if (!on_boundary(x, y, z, n)) {
                interior |= 1u << i;
                dv[i] = div_in[c];
            }
        }
    }
    for (int j = tid; j < nn; j += kClusterThreads) {
        const int lo = sl.start - nn + j, hi = sl.start + len + j;
        if (lo >= 0) buf0[j] = p_at_start(g, p_in, src, lo);
        if (hi < g.cells) buf0[nn + len + j] = p_at_start(g, p_in, src, hi);
    }
    cluster.sync();  // every block has started: its shared memory exists

    const int substeps = 3 * g.s;
    for (int k = 0; k < substeps; ++k) {
        const float* cur = (k & 1) ? buf1 : buf0;
        float* nxt = (k & 1) ? buf0 : buf1;
        if (k > 0 && k % 3 == 0) {
            cluster_receivers(g, sl, k / 3 - 1, cur + nn, src_pre, out);
        }
        // The neighbours' copies of the buffer this substep writes: an
        // edge cell goes into their halos as well.
        float* to_prev = has_prev ? cluster.map_shared_rank(nxt, sl.rank - 1)
                                  : nullptr;
        float* to_next = has_next ? cluster.map_shared_rank(nxt, sl.rank + 1)
                                  : nullptr;
        const bool inject = k % 3 == 2 && k / 3 + 1 < g.s;
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
            const int l = i * kClusterThreads + tid;
            if (l < len) {
                const int h = nn + l;
                const float pc = pr[i];
                float v;
                if (interior >> i & 1u) {
                    float sum = __fadd_rn(cur[h + nn], cur[h - nn]);
                    sum = __fadd_rn(sum, __fadd_rn(cur[h + n], cur[h - n]));
                    sum = __fadd_rn(sum, __fadd_rn(cur[h + 1], cur[h - 1]));
                    const float d = __fsub_rn(
                        __fadd_rn(dv[i], __fmul_rn(g.c6, pc)),
                        __fmul_rn(g.k1, sum));
                    dv[i] = d;
                    v = __fsub_rn(pc, __fmul_rn(g.k2, d));
                } else {
                    v = __fmul_rn(pc, g.absorb);
                }
                if (inject && i == src_i) {
                    *src_pre = v;
                    v = __fadd_rn(v, src[k / 3 + 1]);
                }
                pr[i] = v;
                nxt[h] = v;
                if (has_prev && l < nn) {
                    REMOTE_STORE(to_prev + nn + plen + l, v);
                }
                if (has_next && l >= len - nn) {
                    REMOTE_STORE(to_next + (l - len + nn), v);
                }
            }
        }
        cluster.sync();
    }
    const float* fin = (substeps & 1) ? buf1 : buf0;
    cluster_receivers(g, sl, g.s - 1, fin + nn, src_pre, out);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const int l = i * kClusterThreads + tid;
        if (l < len) {
            p_out[sl.start + l] = pr[i];
            div_out[sl.start + l] = dv[i];  // zero off the interior
        }
    }
}

// csrc/fdtd3d.cu's fdtd_div_cluster_kernel with the hand-offs (st.async
// into the neighbours' halos) and the waits for them left out: the halos
// keep their prologue values, so the results are wrong; what it saves is
// what the exchange costs.
template <int CPT>
__global__ void __launch_bounds__(kClusterThreads, 1)
no_handoff_div_kernel(Grid g, const __grid_constant__ Ranges ranges,
                      const float* __restrict__ src,
                      const float* __restrict__ p_in,
                      const float* __restrict__ div_in,
                      float* __restrict__ p_out, float* __restrict__ div_out,
                      float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    FDTD_MARK(0);
    const int n = g.n, nn = n * n, tid = threadIdx.x;
    const Slab sl = make_slab(ranges);
    float* const src_pre = smem + 4;
    const int w = padded(sl.cap + 2LL * nn);
    float* const buf0 = smem + 8;
    float* const buf1 = buf0 + w;
    const int len = sl.end - sl.start;
    // The constants in registers (not reloaded from the constant bank in
    // every cell), and the pre-injection value's address.
    const float k1 = opaque(g.k1), k2 = opaque(g.k2), c6 = opaque(g.c6);
    const float absorb = opaque(g.absorb);
    const uint32_t pre_a = smem_u32(src_pre);
    const int iters = (len + kClusterThreads - 1) / kClusterThreads;

    float pr[CPT], dv[CPT];
    unsigned interior = 0, valid = 0;
    int src_i = -1;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const int l = i * kClusterThreads + tid;
        pr[i] = dv[i] = 0.f;
        if (l < len) {
            const int c = sl.start + l;
            const int x = c / nn, y = (c / n) % n, z = c % n;
            valid |= 1u << i;
            pr[i] = p_at_start(g, p_in, src, c);
            buf0[nn + l] = pr[i];
            if (c == g.src_cell) src_i = i;
            if (!on_boundary(x, y, z, n)) {
                interior |= 1u << i;
                dv[i] = div_in[c];
            }
        }
    }
    for (int j = tid; j < nn; j += kClusterThreads) {
        const int lo = sl.start - nn + j, hi = sl.end + j;
        if (lo >= 0) buf0[j] = p_at_start(g, p_in, src, lo);
        if (hi < g.cells) buf0[nn + len + j] = p_at_start(g, p_in, src, hi);
    }
    FDTD_MARK(1);
    cluster.sync();  // every block has started
    FDTD_MARK(3);

    const int substeps = 3 * g.s;
    for (int k = 0; k < substeps; ++k) {
        const int q = (k + 1) & 1;  // the buffer this substep writes
        float* const bq = q ? buf1 : buf0;
        const float* cur = (q ? buf0 : buf1) + nn;
        if (k > 0 && k % 3 == 0) {
            cluster_receivers(g, sl, k / 3 - 1, cur, src_pre, out);
            FDTD_MARK(4);
        }
        // The cell of this thread that gets the injection, if any.
        const int inj = (k % 3 == 2 && k / 3 + 1 < g.s) ? src_i : -1;
        const uint32_t a = opaque(smem_u32(cur) + 4u * tid);
        const uint32_t a_n = a + 4 * n, a_mn = a - 4 * n;
        const uint32_t a_nn = a + 4 * nn, a_mnn = a - 4 * nn;
        const uint32_t w0 = a - smem_u32(cur) + smem_u32(bq + nn);
        const uint32_t in_mask = opaque(interior), ok_mask = opaque(valid);
        auto cell = [&](int i) {
            const uint32_t o = 4u * kClusterThreads * i;
            const float pc = pr[i];
            float sum = __fadd_rn(lds(a_nn + o), lds(a_mnn + o));
            sum = __fadd_rn(sum, __fadd_rn(lds(a_n + o), lds(a_mn + o)));
            sum = __fadd_rn(sum, __fadd_rn(lds(a + o + 4), lds(a + o - 4)));
            const float d = __fsub_rn(__fadd_rn(dv[i], __fmul_rn(c6, pc)),
                                      __fmul_rn(k1, sum));
            const bool in = in_mask >> i & 1u;
            const float vi = __fsub_rn(pc, __fmul_rn(k2, d));
            const float vb = __fmul_rn(pc, absorb);
            float v = in ? vi : vb;
            dv[i] = in ? d : dv[i];
            if (i == inj) {
                sts(pre_a, v);
                v = __fadd_rn(v, src[k / 3 + 1]);
            }
            pr[i] = v;
            const bool ok = ok_mask >> i & 1u;
            sts_if(ok, w0 + o, v);
        };
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
            if (runs<CPT>(outside_in<CPT>(j), iters)) cell(outside_in<CPT>(j));
        }
        FDTD_MARK(2);
        __syncthreads();
        FDTD_MARK(3);
    }
    const float* fin = ((substeps & 1) ? buf1 : buf0) + nn;
    cluster_receivers(g, sl, g.s - 1, fin, src_pre, out);
    FDTD_MARK(4);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const int l = i * kClusterThreads + tid;
        if (l < len) {
            p_out[sl.start + l] = pr[i];
            div_out[sl.start + l] = dv[i];  // zero off the interior
        }
    }
    FDTD_MARK(7);
    cluster.sync();  // no block leaves while a neighbour may address it
}

// The two-phase cluster design of the field form (shipped in no kernel:
// it ran no faster than the cooperative fdtd_field_kernel; with EXCH
// false, without its hand-offs and waits). Shared memory: two mbarriers
// (the faces from the next block, p from the previous), the source cell's pre-injection value, then p
// holding cells [start - nn, end) from the origin start - nn, and vx, vy,
// vz holding [start, end + nn), [start, end + n), [start, end + 1) from
// the origin start. A cell's slot of vx, vy, vz holds its lower faces
// vx[x, y, z], vy[x, y, z], vz[x, y, z]: each face has one owner, which
// keeps it in registers and stores it for the neighbours (p stays in
// shared memory only: with it in registers too, 9 cells a thread spill).
// A substep is two phases, each ending in a wait for the neighbour's
// stores: the faces from p (the first cells' faces go up), then p from
// its own faces and its upper neighbours' new ones (the last nn cells' p
// goes down): the plain twin's own order. A substep reads 4 + 4 values
// from shared memory and writes 3 faces and p.
template <int CPT, bool EXCH>
__global__ void __launch_bounds__(kClusterThreads, 1)
two_phase_field_kernel(Grid g, const __grid_constant__ Ranges ranges,
                       const float* __restrict__ src,
                       const float* __restrict__ p_in,
                       const float* __restrict__ vx_in,
                       const float* __restrict__ vy_in,
                       const float* __restrict__ vz_in,
                       float* __restrict__ p_out, float* __restrict__ vx_out,
                       float* __restrict__ vy_out, float* __restrict__ vz_out,
                       float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    FDTD_MARK(0);
    const int n = g.n, nn = n * n, tid = threadIdx.x;
    const Slab sl = make_slab(ranges);
    uint64_t* const bar_v = reinterpret_cast<uint64_t*>(smem);
    uint64_t* const bar_p = bar_v + 1;
    float* const src_pre = smem + 4;
    float* const P = smem + 8;
    float* const VX = P + padded(sl.cap + 1LL * nn);
    float* const VY = VX + padded(sl.cap + 1LL * nn);
    float* const VZ = VY + padded(sl.cap + 1LL * n);
    const int len = sl.end - sl.start;
    const bool has_prev = sl.rank > 0, has_next = sl.rank + 1 < sl.blocks;
    const int expect_v = has_next && EXCH ? 4 * (nn + n + 1) : 0;
    const int expect_p = has_prev && EXCH ? 4 * nn : 0;
    const bool send_v = has_prev && EXCH;
    const bool send_p = has_next && EXCH;
    // The constants in registers, and the pre-injection value's address.
    const float k1 = opaque(g.k1), k2 = opaque(g.k2);
    const float absorb = opaque(g.absorb);
    const uint32_t pre_a = smem_u32(src_pre);
    const int iters = (len + kClusterThreads - 1) / kClusterThreads;
    float* const p_own = P + nn;

    float fx[CPT], fy[CPT], fz[CPT];
    // Per-cell bits, packed into two registers: cell i's x >= 1 at bit i,
    // y >= 1 at CPT + i, z >= 1 at 2 CPT + i, interior at 3 CPT + i, valid
    // at 4 CPT + i.
    static_assert(5 * CPT <= 64, "the field form's cell bits take 5 a cell");
    uint64_t bits = 0;
    int src_i = -1;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const int l = i * kClusterThreads + tid;
        fx[i] = fy[i] = fz[i] = 0.f;
        if (l < len) {
            const int c = sl.start + l;
            const int x = c / nn, y = (c / n) % n, z = c % n;
            fx[i] = vx_in[c];
            fy[i] = vy_in[(x * (n + 1) + y) * n + z];
            fz[i] = vz_in[c + x * n + y];
            p_own[l] = p_at_start(g, p_in, src, c);
            VX[l] = fx[i];
            VY[l] = fy[i];
            VZ[l] = fz[i];
            if (c == g.src_cell) src_i = i;
            bits |= uint64_t{x >= 1} << i | uint64_t{y >= 1} << (CPT + i) |
                    uint64_t{z >= 1} << (2 * CPT + i) |
                    uint64_t{!on_boundary(x, y, z, n)} << (3 * CPT + i) |
                    uint64_t{1} << (4 * CPT + i);
        }
    }
    for (int j = tid; j < nn; j += kClusterThreads) {
        const int lo = sl.start - nn + j, hi = sl.end + j;
        if (lo >= 0) P[j] = p_at_start(g, p_in, src, lo);
        if (hi < g.cells) {
            const int x = hi / nn, y = (hi / n) % n, z = hi % n;
            VX[len + j] = vx_in[hi];
            if (j < n) VY[len + j] = vy_in[(x * (n + 1) + y) * n + z];
            if (j < 1) VZ[len + j] = vz_in[hi + x * n + y];
        }
    }
    if (tid == 0) {
        mbar_init(bar_v);
        mbar_init(bar_p);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    FDTD_MARK(1);
    cluster.sync();  // every block has started, its mbarriers initialised
    FDTD_MARK(3);

    // The neighbours' copies: the first cells' faces go to the previous
    // block's upper halos (vy and vz at fixed offsets from vx), the last nn
    // cells' p to the next block's lower halo.
    const Remote up_x(VX, sl.prev_start, sl.start, bar_v,
                      has_prev ? sl.rank - 1 : sl.rank);
    const uint32_t to_vy = 4u * static_cast<uint32_t>(VY - VX);
    const uint32_t to_vz = 4u * static_cast<uint32_t>(VZ - VX);
    const Remote down_p(P, sl.end - nn, sl.start, bar_p,
                        has_next ? sl.rank + 1 : sl.rank);
    const int substeps = 3 * g.s;
    for (int k = 0; k < substeps; ++k) {
        const bool last = k + 1 == substeps;
        if (k > 0 && k % 3 == 0) {
            cluster_receivers(g, sl, k / 3 - 1, p_own, src_pre, out);
            FDTD_MARK(4);
        }
        // Phase 1: each cell's lower faces (index 1..n-1 on their axis)
        // from p; the first nn cells' faces go up.
        if (tid == 0 && expect_v > 0) mbar_expect(bar_v, expect_v);
        {
            const uint32_t pa = opaque(smem_u32(p_own) + 4u * tid);
            const uint32_t pa_mn = pa - 4 * n, pa_mnn = pa - 4 * nn;
            const uint32_t xa = pa - smem_u32(p_own) + smem_u32(VX);
            const uint32_t ya = xa - smem_u32(VX) + smem_u32(VY);
            const uint32_t za = xa - smem_u32(VX) + smem_u32(VZ);
            const uint32_t lo = opaque(static_cast<uint32_t>(bits));
            const uint32_t hi = opaque(static_cast<uint32_t>(bits >> 32));
            // Bit b of the packed per-cell bits.
            auto bit = [&](int b) {
                return ((b < 32 ? lo >> b : hi >> (b - 32)) & 1u) != 0;
            };
            auto faces = [&](int i) {
                const uint32_t o = 4u * kClusterThreads * i;
                const int l = i * kClusterThreads + tid;
                const float pc = lds(pa + o);
                const float nx = face(fx[i], pc, lds(pa_mnn + o), k1);
                const float ny = face(fy[i], pc, lds(pa_mn + o), k1);
                const float nz = face(fz[i], pc, lds(pa + o - 4), k1);
                fx[i] = bit(i) ? nx : fx[i];
                fy[i] = bit(CPT + i) ? ny : fy[i];
                fz[i] = bit(2 * CPT + i) ? nz : fz[i];
                const bool ok = bit(4 * CPT + i);
                sts_if(ok, xa + o, fx[i]);
                sts_if(ok, ya + o, fy[i]);
                sts_if(ok, za + o, fz[i]);
                if (send_v && l < nn) {
                    store_async(up_x.slot + o, fx[i], up_x.bar);
                    if (l < n) {
                        store_async(up_x.slot + to_vy + o, fy[i], up_x.bar);
                    }
                    if (l < 1) {
                        store_async(up_x.slot + to_vz + o, fz[i], up_x.bar);
                    }
                }
            };
            // In order: the first nn cells, which go up, come first.
#pragma unroll
            for (int i = 0; i < CPT; ++i) {
                if (runs<CPT>(i, iters)) faces(i);
            }
            FDTD_MARK(2);
            __syncthreads();
            if (expect_v > 0) mbar_wait(bar_v, k & 1);
            FDTD_MARK(3);
        }
        // Phase 2: p from its own faces and its upper neighbours' new ones;
        // the last nn cells' p goes down.
        const bool wait_p = !last && expect_p > 0;
        if (tid == 0 && wait_p) mbar_expect(bar_p, expect_p);
        // The cell of this thread that gets the injection, if any.
        const int inj = (k % 3 == 2 && k / 3 + 1 < g.s) ? src_i : -1;
        {
            const uint32_t pa = opaque(smem_u32(p_own) + 4u * tid);
            const uint32_t xa = pa - smem_u32(p_own) + smem_u32(VX);
            const uint32_t ya = xa - smem_u32(VX) + smem_u32(VY);
            const uint32_t za = xa - smem_u32(VX) + smem_u32(VZ);
            const uint32_t xa_nn = xa + 4 * nn, ya_n = ya + 4 * n;
            const uint32_t lo = opaque(static_cast<uint32_t>(bits));
            const uint32_t hi = opaque(static_cast<uint32_t>(bits >> 32));
            auto bit = [&](int b) {
                return ((b < 32 ? lo >> b : hi >> (b - 32)) & 1u) != 0;
            };
            const bool sending = send_p && !last;
            auto pressure = [&](int i) {
                const uint32_t o = 4u * kClusterThreads * i;
                const int l = i * kClusterThreads + tid;
                const float pc = lds(pa + o);
                const float d = __fadd_rn(
                    __fadd_rn(__fsub_rn(lds(xa_nn + o), fx[i]),
                              __fsub_rn(lds(ya_n + o), fy[i])),
                    __fsub_rn(lds(za + o + 4), fz[i]));
                const float vi = __fsub_rn(pc, __fmul_rn(k2, d));
                const float vb = __fmul_rn(pc, absorb);
                float v = bit(3 * CPT + i) ? vi : vb;
                if (i == inj) {
                    sts(pre_a, v);
                    v = __fadd_rn(v, src[k / 3 + 1]);
                }
                const bool ok = bit(4 * CPT + i);
                sts_if(ok, pa + o, v);
                if (sending && ok && l >= len - nn) {
                    store_async(down_p.slot + o, v, down_p.bar);
                }
            };
            // Backwards: the last nn cells, which go down, come first.
#pragma unroll
            for (int i = CPT - 1; i >= 0; --i) {
                if (runs<CPT>(i, iters)) pressure(i);
            }
            FDTD_MARK(6);
            __syncthreads();
            if (wait_p) mbar_wait(bar_p, k & 1);
            FDTD_MARK(3);
        }
    }
    cluster_receivers(g, sl, g.s - 1, p_own, src_pre, out);
    FDTD_MARK(4);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        const int l = i * kClusterThreads + tid;
        if (l < len) {
            const int c = sl.start + l;
            const int x = c / nn, y = (c / n) % n, z = c % n;
            p_out[c] = p_own[l];
            vx_out[c] = fx[i];
            vy_out[(x * (n + 1) + y) * n + z] = fy[i];
            vz_out[c + x * n + y] = fz[i];
        }
    }
    // The faces no cell owns (vx[n, :, :], vy[:, n, :], vz[:, :, n]) are
    // never updated: copied through, spread over the cluster.
    for (int j = sl.rank * kClusterThreads + tid; j < nn;
         j += sl.blocks * kClusterThreads) {
        const int a = j / n, b = j % n;
        const int jx = n * nn + j;                 // vx[n, a, b]
        const int jy = (a * (n + 1) + n) * n + b;  // vy[a, n, b]
        const int jz = (a * n + b) * (n + 1) + n;  // vz[a, b, n]
        vx_out[jx] = vx_in[jx];
        vy_out[jy] = vy_in[jy];
        vz_out[jz] = vz_in[jz];
    }
    FDTD_MARK(7);
    cluster.sync();  // no block leaves while a neighbour may address it
}

// Dynamic shared memory a block of the two-phase field design takes: 8
// floats, then p [n^2 | range], vx [range | n^2], vy [range | n], vz
// [range | 1].
long long two_phase_smem(int n, int cap) {
    const long long nn = 1LL * n * n;
    return 4 * (8LL + 2 * padded(cap + nn) + padded(cap + n) + padded(cap + 1));
}

using FieldKernel = void (*)(Grid, Ranges, const float*, const float*,
                             const float*, const float*, const float*, float*,
                             float*, float*, float*, float*);

// The two-phase field builds: each odd count of cells a thread up to 11
// (5 bits a cell in one 64-bit register), without the hand-offs only 9
// (room 50 on 16 blocks).
FieldKernel two_phase_kernel(int cpt, bool exchange) {
    if (!exchange) return cpt == 9 ? two_phase_field_kernel<9, false> : nullptr;
    switch (cpt) {
        case 1: return two_phase_field_kernel<1, true>;
        case 3: return two_phase_field_kernel<3, true>;
        case 5: return two_phase_field_kernel<5, true>;
        case 7: return two_phase_field_kernel<7, true>;
        case 9: return two_phase_field_kernel<9, true>;
        case 11: return two_phase_field_kernel<11, true>;
        default: return nullptr;
    }
}

// A launch of a divergence-form design on one cluster, built for 9 cells
// a thread (room 50 on 16 blocks); smem < 0 takes the shipped layout's.
template <typename K>
int div_design_launch(K kernel, long long smem, const float* src,
                      const float* p_in, const float* div_in, float* p_out,
                      float* div_out, float* out, int n, int s, int src_cell,
                      int tracks, int rcv_cell, float k1, float k2, float c6,
                      float absorb, float out_scale, const int* starts,
                      int blocks, void* stream) {
    Ranges r;
    if (bad_shape(n, s, tracks, src_cell) ||
        !cluster_ranges(n, starts, blocks, &r) ||
        cells_per_thread(r.cap) != 9) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (smem < 0) smem = div_cluster_smem(n, r.cap);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_config((const void*)kernel, blocks, smem,
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

// ---- the grid-stride kernels the plane route replaced -------------------
//
// The field form's grid-stride cooperative kernel (old_field_kernel, the
// shipped field kernel before the plane route; verbatim but for its name),
// its helpers, and the grid barrier alone (a probe at its grid).

constexpr int kThreads = 512;

// Rows of out for sample smp, read from p after the sample's last
// substep. src_pre holds the source cell's value from before the
// injection of sample smp + 1, when there was one.
__device__ void read_receivers(const Grid& g, int smp, const float* p,
                               const float* src_pre, float* out, int tid,
                               int stride) {
    const bool injected = smp + 1 < g.s;
    for (int t = tid; t < g.tracks; t += stride) {
        const int cell = g.rcv_rows ? g.rcv_rows[t] : g.rcv_cell;
        float v;
        if (cell < 0 || cell >= g.cells) {
            v = __int_as_float(0x7fc00000);  // NaN: no such cell
        } else if (injected && cell == g.src_cell) {
            v = __ldcg(src_pre);
        } else {
            v = __ldcg(p + cell);
        }
        out[static_cast<long long>(t) * g.s + smp] = __fmul_rn(v, g.out_scale);
    }
}

// The value written to the source cell's next buffer at the end of a
// sample: the injection of the next sample, the pre-injection value kept.
__device__ __forceinline__ float inject(const Grid& g, int c, int k,
                                        float v, const float* src,
                                        float* src_pre) {
    if (c == g.src_cell && k % 3 == 2 && k / 3 + 1 < g.s) {
        *src_pre = v;
        v = __fadd_rn(v, src[k / 3 + 1]);
    }
    return v;
}

__global__ void __launch_bounds__(kThreads)
old_field_kernel(Grid g, const float* __restrict__ src,
                  const float* __restrict__ p_in,
                  const float* __restrict__ vx_in,
                  const float* __restrict__ vy_in,
                  const float* __restrict__ vz_in,
                  float* pa, float* pb, float* vxa, float* vxb, float* vya,
                  float* vyb, float* vza, float* vzb, float* out,
                  float* src_pre) {
    cg::grid_group grid = cg::this_grid();
    const int n = g.n, nn = n * n;
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int stride = gridDim.x * blockDim.x;
    const int vx_cells = (n + 1) * nn;  // vy and vz have as many faces

    // Prologue: both velocity buffers get the input, so the faces no
    // substep updates (x = 0 and x = n of vx, and so on) hold it in both.
    for (int c = tid; c < g.cells; c += stride) {
        float v = p_in[c];
        if (c == g.src_cell) v = __fadd_rn(v, src[0]);
        pa[c] = v;
    }
    for (int f = tid; f < vx_cells; f += stride) {
        vxa[f] = vxb[f] = vx_in[f];
        vya[f] = vyb[f] = vy_in[f];
        vza[f] = vzb[f] = vz_in[f];
    }
    grid.sync();

    const int substeps = 3 * g.s;
    for (int k = 0; k < substeps; ++k) {
        const bool odd = k & 1;
        const float* cur = odd ? pb : pa;
        float* nxt = odd ? pa : pb;
        const float* vx = odd ? vxb : vxa;
        const float* vy = odd ? vyb : vya;
        const float* vz = odd ? vzb : vza;
        float* vx2 = odd ? vxa : vxb;
        float* vy2 = odd ? vya : vyb;
        float* vz2 = odd ? vza : vzb;
        if (k > 0 && k % 3 == 0) {
            read_receivers(g, k / 3 - 1, cur, src_pre, out, tid, stride);
        }
        for (int c = tid; c < g.cells; c += stride) {
            const int x = c / nn, y = (c / n) % n, z = c % n;
            const int fx = c;                         // vx[x, y, z]
            const int fy = (x * (n + 1) + y) * n + z;  // vy[x, y, z]
            const int fz = c + x * n + y;              // vz[x, y, z]
            const float pc = __ldcg(cur + c);
            // This cell's lower faces (index 1..n-1 on their axis).
            float vx0 = __ldcg(vx + fx), vy0 = __ldcg(vy + fy),
                  vz0 = __ldcg(vz + fz);
            if (x >= 1) {
                vx0 = face(vx0, pc, __ldcg(cur + c - nn), g.k1);
                vx2[fx] = vx0;
            }
            if (y >= 1) {
                vy0 = face(vy0, pc, __ldcg(cur + c - n), g.k1);
                vy2[fy] = vy0;
            }
            if (z >= 1) {
                vz0 = face(vz0, pc, __ldcg(cur + c - 1), g.k1);
                vz2[fz] = vz0;
            }
            float v;
            if (on_boundary(x, y, z, n)) {
                v = __fmul_rn(pc, g.absorb);
            } else {
                // The upper faces, as their own cells' threads update them.
                const float vx1 = face(__ldcg(vx + fx + nn), __ldcg(cur + c + nn),
                                       pc, g.k1);
                const float vy1 = face(__ldcg(vy + fy + n), __ldcg(cur + c + n),
                                       pc, g.k1);
                const float vz1 = face(__ldcg(vz + fz + 1), __ldcg(cur + c + 1),
                                       pc, g.k1);
                const float d = __fadd_rn(
                    __fadd_rn(__fsub_rn(vx1, vx0), __fsub_rn(vy1, vy0)),
                    __fsub_rn(vz1, vz0));
                v = __fsub_rn(pc, __fmul_rn(g.k2, d));
            }
            nxt[c] = inject(g, c, k, v, src, src_pre);
        }
        grid.sync();
    }
    read_receivers(g, g.s - 1, (substeps & 1) ? pb : pa, src_pre, out, tid,
                   stride);
}

// Only the grid-wide barrier, `syncs` times: what one substep's sync
// costs at a given grid size, with no stencil work (PERF.md).
__global__ void __launch_bounds__(kThreads) fdtd_sync_probe_kernel(int syncs) {
    cg::grid_group grid = cg::this_grid();
    for (int i = 0; i < syncs; ++i) grid.sync();
}

// Blocks of 512 threads of a cooperative launch of `kernel` that fit on
// the current device at once, capped at what `work` items need; 0 with
// *err set when the device cannot launch them cooperatively.
template <typename K>
int grid_blocks(K kernel, long long work, cudaError_t* err) {
    const long long fit = coresident_blocks((const void*)kernel, kThreads, 0,
                                            err);
    const long long need = (work + kThreads - 1) / kThreads;
    return static_cast<int>(need < fit ? need : fit);
}

// The grid-sync kernel: the cooperative divergence kernel that the plane
// route replaced, verbatim but for its name.
__global__ void __launch_bounds__(kThreads)
old_coop_div_kernel(Grid g, const float* __restrict__ src,
                    const float* __restrict__ p_in,
                    const float* __restrict__ div_in,
                    float* pa, float* pb, float* div, float* out,
                    float* src_pre) {
    cg::grid_group grid = cg::this_grid();
    const int n = g.n, nn = n * n;
    const int tid = blockIdx.x * blockDim.x + threadIdx.x;
    const int stride = gridDim.x * blockDim.x;

    for (int c = tid; c < g.cells; c += stride) {
        const int x = c / nn, y = (c / n) % n, z = c % n;
        float v = p_in[c];
        if (c == g.src_cell) v = __fadd_rn(v, src[0]);
        pa[c] = v;
        div[c] = on_boundary(x, y, z, n) ? 0.f : div_in[c];
    }
    grid.sync();

    const int substeps = 3 * g.s;
    for (int k = 0; k < substeps; ++k) {
        const float* cur = (k & 1) ? pb : pa;
        float* nxt = (k & 1) ? pa : pb;
        if (k > 0 && k % 3 == 0) {
            read_receivers(g, k / 3 - 1, cur, src_pre, out, tid, stride);
        }
        for (int c = tid; c < g.cells; c += stride) {
            const int x = c / nn, y = (c / n) % n, z = c % n;
            const float pc = __ldcg(cur + c);
            float v;
            if (on_boundary(x, y, z, n)) {
                v = __fmul_rn(pc, g.absorb);
            } else {
                float sum = __fadd_rn(__ldcg(cur + c + nn), __ldcg(cur + c - nn));
                sum = __fadd_rn(sum, __fadd_rn(__ldcg(cur + c + n),
                                               __ldcg(cur + c - n)));
                sum = __fadd_rn(sum, __fadd_rn(__ldcg(cur + c + 1),
                                               __ldcg(cur + c - 1)));
                const float d = __fsub_rn(__fadd_rn(div[c], __fmul_rn(g.c6, pc)),
                                          __fmul_rn(g.k1, sum));
                div[c] = d;
                v = __fsub_rn(pc, __fmul_rn(g.k2, d));
            }
            nxt[c] = inject(g, c, k, v, src, src_pre);
        }
        grid.sync();
    }
    read_receivers(g, g.s - 1, (substeps & 1) ? pb : pa, src_pre, out, tid,
                   stride);
}

// The shipped plane kernel with WAIT false (no flag waits: each block
// runs ahead on whatever the exchange holds) or EXCHANGE false too (the
// +-n^2 neighbours read from the block's own plane in shared memory, no
// exchange stores): timings of the waits and of the exchange, wrong
// results. With PRE, right: the y and z pair sums of every cell for
// substep k + 1 are taken from the new plane while thread 0 and 32 wait
// for the neighbours' flags after substep k (the sum's order unchanged:
// (x pair + y pair) + z pair).
template <int CPT, bool WAIT, bool EXCHANGE, bool PRE = false>
__global__ void __launch_bounds__(kClusterThreads, 1)
planes_variant_kernel(Grid g, const float* __restrict__ src,
                      const float* __restrict__ p_in,
                      const float* __restrict__ div_in,
                      float* __restrict__ p_out, float* __restrict__ div_out,
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
    float* const pub0 = xch + (b + 1) * stride + tid;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        stcg_if(valid >> i & 1u, pub0 + i * kClusterThreads, pr[i]);
    }
    if (tid == 0) *own_flag = 0;
    FDTD_MARK(1);
    cg::this_grid().sync();
    FDTD_MARK(3);

    // The in-plane pair sums of the coming substep, from the plane at
    // shared::cta address base + 4 tid.
    float yy[CPT], zz[CPT];
    auto pairs = [&](uint32_t base) {
        const uint32_t a = opaque(base + 4u * tid);
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
            const uint32_t o = 4u * kClusterThreads * i;
            if (runs<CPT>(i, iters)) {
                yy[i] = __fadd_rn(lds(a + o + 4 * n), lds(a + o - 4 * n));
                zz[i] = __fadd_rn(lds(a + o + 4), lds(a + o - 4));
            }
        }
    };
    if (PRE) pairs(smem_u32(buf0));

    const int substeps = 3 * g.s;
    for (int k = 0; k < substeps; ++k) {
        const int q = (k + 1) & 1;
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
        const float* const dn =
            opaque(xch + (k & 1) * parity + b * stride + tid);
        const float* const up = dn + 2 * stride;
        float* const pub = xch + q * parity + (b + 1) * stride + tid;
        auto cell = [&](int i) {
            const uint32_t o = 4u * kClusterThreads * i;
            const int og = kClusterThreads * i;
            const float xp = EXCHANGE ? ldcg(up + og) : lds(a + o + 8);
            const float xm = EXCHANGE ? ldcg(dn + og) : lds(a + o - 8);
            float v = PRE ? div_pairs(pr[i], dv[i], in_mask >> i & 1u,
                                      __fadd_rn(xp, xm), yy[i], zz[i], k1, k2,
                                      c6, absorb)
                          : div_cell(pr[i], dv[i], in_mask >> i & 1u, xp, xm,
                                     lds(a_n + o), lds(a_mn + o),
                                     lds(a + o + 4), lds(a + o - 4), k1, k2,
                                     c6, absorb);
            if (i == inj) {
                sts(pre_a, v);
                v = __fadd_rn(v, src[k / 3 + 1]);
            }
            pr[i] = v;
            const bool ok = ok_mask >> i & 1u;
            sts_if(ok, w0 + o, v);
            if (EXCHANGE && send) stcg_if(ok, pub + og, v);
        };
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
            if (runs<CPT>(i, iters)) cell(i);
        }
        FDTD_MARK(2);
        __syncthreads();
        if (send) {
            if (tid == 0) flag_release(own_flag, k + 1);
            if (PRE) pairs(smem_u32(bq));
            if (WAIT && tid == 0 && has_prev) {
                flag_wait(own_flag - kFlagStride, k + 1);
            }
            if (WAIT && tid == 32 && has_next) {
                flag_wait(own_flag + kFlagStride, k + 1);
            }
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

// The variant builds: rooms 66, 82, 100 and 128 (5, 7, 11 and 17 cells a
// thread; 1 for the checks at small rooms); mode 1 without the waits, 2
// without the exchange too, 3 with the pair sums taken in the wait.
DivPlanesKernel planes_variant(int cpt, int mode) {
#define FDTD_VARIANT(c)                                              \
    case c:                                                          \
        return mode == 1   ? planes_variant_kernel<c, false, true>   \
               : mode == 2 ? planes_variant_kernel<c, false, false>  \
                           : planes_variant_kernel<c, true, true, true>;
    if (mode < 1 || mode > 3) return nullptr;
    switch (cpt) {
        FDTD_VARIANT(1) FDTD_VARIANT(5) FDTD_VARIANT(7) FDTD_VARIANT(11)
        FDTD_VARIANT(17)
        default: return nullptr;
    }
#undef FDTD_VARIANT
}

// A float of shared::cluster address addr.
__device__ __forceinline__ float ld_dsmem(uint32_t addr) {
    float v;
    asm("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr));
    return v;
}

// The plane kernel on clusters of two planes (block b = 2c + r, rank r of
// cluster c; a grid of n rounded up to even, the extra block idle). Rank
// 0's next plane and rank 1's previous one are the partner's, read from
// its shared memory; the other neighbour's comes through the exchange as
// in the shipped kernel. The flags count published planes, the prologue's
// included (the launcher zeroes them): substep k waits for the
// neighbours' flags to reach k + 1, so no grid sync is needed; a cluster
// barrier after the prologue and one before exit (no block leaves while
// its partner may read it).
template <int CPT>
__global__ void __launch_bounds__(kClusterThreads, 1)
planes_pair_kernel(Grid g, const float* __restrict__ src,
                   const float* __restrict__ p_in,
                   const float* __restrict__ div_in,
                   float* __restrict__ p_out, float* __restrict__ div_out,
                   float* __restrict__ out, float* xch, int* flags) {
    extern __shared__ __align__(16) float smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int n = g.n, nn = n * n, tid = threadIdx.x;
    const int b = blockIdx.x, blocks = n;
    if (b >= n) {  // the idle partner of the last plane
        cluster.sync();
        cluster.sync();
        return;
    }
    const int rank = static_cast<int>(cluster.block_rank());
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
    float* const pub0 = xch + (b + 1) * stride + tid;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
        stcg_if(valid >> i & 1u, pub0 + i * kClusterThreads, pr[i]);
    }
    __syncthreads();
    if (tid == 0) flag_release(own_flag, 1);
    cluster.sync();  // the partner's shared memory exists
    if (tid == 0 && has_prev) flag_wait(own_flag - kFlagStride, 1);
    if (tid == 32 && has_next) flag_wait(own_flag + kFlagStride, 1);
    __syncthreads();

    const int substeps = 3 * g.s;
    for (int k = 0; k < substeps; ++k) {
        const int q = (k + 1) & 1;
        float* const bq = q ? buf1 : buf0;
        const float* cur = q ? buf0 : buf1;
        const bool send = k + 1 < substeps;
        if (k > 0 && k % 3 == 0) {
            cluster_receivers(g, sl, k / 3 - 1, cur, src_pre, out);
        }
        const int inj = (k % 3 == 2 && k / 3 + 1 < g.s) ? src_i : -1;
        const uint32_t a = opaque(smem_u32(cur) + 4u * tid);
        const uint32_t a_n = a + 4 * n, a_mn = a - 4 * n;
        const uint32_t w0 = a - smem_u32(cur) + smem_u32(bq);
        const uint32_t in_mask = opaque(interior), ok_mask = opaque(valid);
        // The partner's copy of cur, and the other neighbour's slot.
        const uint32_t ra = in_rank(a, rank ^ 1);
        const float* const l2 = opaque(xch + (k & 1) * parity +
                                       (rank ? b + 2 : b) * stride + tid);
        float* const pub = xch + q * parity + (b + 1) * stride + tid;
        auto cell = [&](int i) {
            const uint32_t o = 4u * kClusterThreads * i;
            const int og = kClusterThreads * i;
            const float rem = ld_dsmem(ra + o), far = ldcg(l2 + og);
            float v = div_cell(pr[i], dv[i], in_mask >> i & 1u,
                               rank ? far : rem, rank ? rem : far,
                               lds(a_n + o), lds(a_mn + o), lds(a + o + 4),
                               lds(a + o - 4), k1, k2, c6, absorb);
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
        __syncthreads();
        if (send) {
            if (tid == 0) flag_release(own_flag, k + 2);
            if (tid == 0 && has_prev) flag_wait(own_flag - kFlagStride, k + 2);
            if (tid == 32 && has_next) flag_wait(own_flag + kFlagStride, k + 2);
            __syncthreads();
        }
    }
    const float* fin = (substeps & 1) ? buf1 : buf0;
    cluster_receivers(g, sl, g.s - 1, fin, src_pre, out);
    store_cells<CPT>(sl.start, nn, pr, dv, p_out, div_out);
    cluster.sync();
}

DivPlanesKernel planes_pair(int cpt) {
    switch (cpt) {
        case 1: return planes_pair_kernel<1>;
        case 5: return planes_pair_kernel<5>;
        case 7: return planes_pair_kernel<7>;
        case 11: return planes_pair_kernel<11>;
        case 17: return planes_pair_kernel<17>;
        default: return nullptr;
    }
}

}  // namespace

// The first design; arguments as fdtd_div_cluster_launch.
extern "C" int barrier_div_launch(const float* src, const float* p_in,
                                  const float* div_in, float* p_out,
                                  float* div_out, float* out, int n, int s,
                                  int src_cell, int tracks, int rcv_cell,
                                  float k1, float k2, float c6, float absorb,
                                  float out_scale, const int* starts,
                                  int blocks, void* stream) {
    Ranges r;
    if (!cluster_ranges(n, starts, blocks, &r)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return div_design_launch(barrier_div_kernel<9>,
                             4LL * (2LL * (r.cap + 2LL * n * n) + 1), src,
                             p_in, div_in, p_out, div_out, out, n, s,
                             src_cell, tracks, rcv_cell, k1, k2, c6, absorb,
                             out_scale, starts, blocks, stream);
}

// The shipped kernel without its hand-offs; arguments as
// fdtd_div_cluster_launch.
extern "C" int no_handoff_div_launch(const float* src, const float* p_in,
                                     const float* div_in, float* p_out,
                                     float* div_out, float* out, int n,
                                     int s, int src_cell, int tracks,
                                     int rcv_cell, float k1, float k2,
                                     float c6, float absorb, float out_scale,
                                     const int* starts, int blocks,
                                     void* stream) {
    return div_design_launch(no_handoff_div_kernel<9>, -1, src, p_in, div_in,
                             p_out, div_out, out, n, s, src_cell, tracks,
                             rcv_cell, k1, k2, c6, absorb, out_scale, starts,
                             blocks, stream);
}

// The two-phase field design: p_in (n^3,), vx_in (n+1, n, n), vy_in (n,
// n+1, n), vz_in (n, n, n+1) read only; p_out, vx_out, vy_out, vz_out of
// the same shapes receive the fields; out (tracks, s), the receiver of
// row t rcv_rows[t], or rcv_cell when rcv_rows is null; ranges as
// fdtd_div_cluster_launch; exchange 0 leaves the hand-offs out.
extern "C" int two_phase_field_launch(
    const float* src, const float* p_in, const float* vx_in,
    const float* vy_in, const float* vz_in, float* p_out, float* vx_out,
    float* vy_out, float* vz_out, float* out, const int* rcv_rows, int n,
    int s, int src_cell, int tracks, int rcv_cell, float k1, float k2,
    float absorb, float out_scale, const int* starts, int blocks,
    int exchange, void* stream) {
    Ranges r;
    if (bad_shape(n, s, tracks, src_cell) ||
        !cluster_ranges(n, starts, blocks, &r)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const FieldKernel kernel =
        two_phase_kernel(cells_per_thread(r.cap), exchange != 0);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_config((const void*)kernel, blocks,
                                     two_phase_smem(n, r.cap),
                                     static_cast<cudaStream_t>(stream), &cfg,
                                     &attr);
    if (err != cudaSuccess) return static_cast<int>(err);
    const Grid g = make_grid(n, s, src_cell, tracks, rcv_cell, rcv_rows, k1,
                             k2, 0.f, absorb, out_scale);
    err = cudaLaunchKernelEx(&cfg, kernel, g, r, src, p_in, vx_in, vy_in,
                             vz_in, p_out, vx_out, vy_out, vz_out, out);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// The two-phase design's shared memory a block on those ranges (-1 when
// they cannot carry the grid).
extern "C" long long two_phase_field_smem(int n, const int* starts,
                                          int blocks) {
    Ranges r;
    if (!cluster_ranges(n, starts, blocks, &r)) return -1;
    return two_phase_smem(n, r.cap);
}

// The grid-sync kernel's launch (the replaced fdtd_div_launch): src (s,),
// p_in and div_in (n^3,) read only; pa, pb (n^3,) scratch: after the
// block p' is in pa when s is even, pb when odd; div (n^3,) receives
// div'; out (tracks, s); src_pre (1,) scratch.
extern "C" int old_coop_div_launch(const float* src, const float* p_in,
                                   const float* div_in, float* pa, float* pb,
                                   float* div, float* out, float* src_pre,
                                   int n, int s, int src_cell, int tracks,
                                   int rcv_cell, float k1, float k2, float c6,
                                   float absorb, float out_scale,
                                   void* stream) {
    if (bad_shape(n, s, tracks, src_cell)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err;
    const int blocks = grid_blocks(old_coop_div_kernel, 1LL * n * n * n, &err);
    if (blocks == 0) return static_cast<int>(err);
    Grid g = make_grid(n, s, src_cell, tracks, rcv_cell, nullptr, k1, k2, c6,
                       absorb, out_scale);
    void* args[] = {&g, &src, &p_in, &div_in, &pa, &pb, &div, &out, &src_pre};
    err = cudaLaunchCooperativeKernel(
        (const void*)old_coop_div_kernel, dim3(blocks), dim3(kThreads), args,
        0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// The blocks of the grid-sync kernel's launch for an n^3 grid.
extern "C" int old_coop_div_blocks(int n) {
    cudaError_t err;
    return grid_blocks(old_coop_div_kernel, 1LL * n * n * n, &err);
}

// A plane-kernel variant (planes_variant's mode); the rest of the
// arguments as fdtd_div_planes_launch.
extern "C" int planes_variant_launch(
    const float* src, const float* p_in, const float* div_in, float* p_out,
    float* div_out, float* out, float* xch, int* flags, int n, int s,
    int src_cell, int tracks, int rcv_cell, float k1, float k2, float c6,
    float absorb, float out_scale, const int* starts, int blocks, int mode,
    void* stream) {
    if (bad_shape(n, s, tracks, src_cell) ||
        !plane_ranges(n, starts, blocks)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const DivPlanesKernel kernel =
        planes_variant(cells_per_thread(1LL * n * n), mode);
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const long long smem = div_planes_smem(n);
    cudaError_t err;
    const int fit = coresident_blocks((const void*)kernel, kClusterThreads,
                                            smem, &err);
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

// The pair design (rooms 8 and below, 66, 82, 100 and 128: 1, 5, 7, 11
// and 17 cells a thread); the arguments as fdtd_div_planes_launch, and
// cooperative: 1 to launch with the cooperative attribute beside the
// cluster dimension, 0 without it (the co-residency then checked with
// cudaOccupancyMaxActiveClusters). Zeroes the flags first.
extern "C" int planes_pair_launch(
    const float* src, const float* p_in, const float* div_in, float* p_out,
    float* div_out, float* out, float* xch, int* flags, int n, int s,
    int src_cell, int tracks, int rcv_cell, float k1, float k2, float c6,
    float absorb, float out_scale, const int* starts, int blocks,
    int cooperative, void* stream) {
    if (bad_shape(n, s, tracks, src_cell) ||
        !plane_ranges(n, starts, blocks)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const DivPlanesKernel kernel = planes_pair(cells_per_thread(1LL * n * n));
    if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const long long smem = div_planes_smem(n);
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[2];
    cfg.gridDim = dim3(n + (n & 1));
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cooperative ? 2 : 1;
    if (!cooperative) {
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel,
                                             &cfg);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (2 * clusters < n + (n & 1)) {
            return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
        }
    }
    err = cudaMemsetAsync(flags, 0, sizeof(int) * kFlagStride * n,
                          static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    const Grid g = make_grid(n, s, src_cell, tracks, rcv_cell, nullptr, k1,
                             k2, c6, absorb, out_scale);
    err = cudaLaunchKernelEx(&cfg, kernel, g, src, p_in, div_in, p_out,
                             div_out, out, xch, flags);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// Clusters of two of the pair design the card holds at once for an n^3
// grid (negated CUDA error when the query fails).
extern "C" int planes_pair_occupancy(int n) {
    const DivPlanesKernel kernel = planes_pair(cells_per_thread(1LL * n * n));
    if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
    const long long smem = div_planes_smem(n);
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    cfg.gridDim = dim3(n + (n & 1));
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = 2;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel,
                                             &cfg);
    }
    return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// The field plane kernel's builds beside the shipped ones: either
// layout (reg_faces 1: the faces in registers, p alone in shared memory;
// 0: vy and vz in shared memory) at rooms up to 82 (1, 3, 5 and 7 cells a
// thread); and, in the shipped layout at rooms 50, 82 and 128, mode 1
// without the flag waits (each block runs ahead on whatever the exchange
// holds), mode 2 without the exchange too (the +-n^2 neighbours read from
// the block's own plane): timings of what the waits and the exchange
// cost, wrong results. Null for any other combination.
FieldPlanesKernel field_planes_variant(int cpt, int reg_faces, int mode) {
#define FDTD_FIELD_LAYOUT(c, r)                                            \
    if (cpt == c && reg_faces == (r) && mode == 0) {                       \
        return fdtd_field_planes_kernel<c, r>;                             \
    }
#define FDTD_FIELD_CUTS(c, r)                                              \
    if (cpt == c && reg_faces == (r) && mode == 1) {                       \
        return fdtd_field_planes_kernel<c, r, false>;                      \
    }                                                                      \
    if (cpt == c && reg_faces == (r) && mode == 2) {                       \
        return fdtd_field_planes_kernel<c, r, false, false>;               \
    }
    FDTD_FIELD_LAYOUT(1, true)
    FDTD_FIELD_LAYOUT(1, false)
    FDTD_FIELD_LAYOUT(3, true)
    FDTD_FIELD_LAYOUT(3, false)
    FDTD_FIELD_LAYOUT(5, true)
    FDTD_FIELD_LAYOUT(5, false)
    FDTD_FIELD_LAYOUT(7, true)
    FDTD_FIELD_LAYOUT(7, false)
    FDTD_FIELD_CUTS(3, true)
    FDTD_FIELD_CUTS(7, true)
    FDTD_FIELD_CUTS(17, false)
#undef FDTD_FIELD_LAYOUT
#undef FDTD_FIELD_CUTS
    return nullptr;
}

// A field plane build of field_planes_variant; the other arguments as
// fdtd_field_planes_launch's.
extern "C" int field_planes_variant_launch(
    int reg_faces, int mode, const float* src, const float* p_in,
    const float* vx_in, const float* vy_in, const float* vz_in, float* p_out,
    float* vx_out, float* vy_out, float* vz_out, float* out, float* xch,
    int* flags, const int* rcv_rows, const int* order, const int* rcv_starts,
    int n, int s, int src_cell, int tracks, int rcv_cell, float k1, float k2,
    float absorb, float out_scale, const int* starts, int blocks,
    void* stream) {
    if (n < 3 || n > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
    return field_planes_launch(
        field_planes_variant(cells_per_thread(1LL * n * n), reg_faces, mode),
        field_planes_smem(n, reg_faces != 0), src, p_in, vx_in, vy_in, vz_in,
        p_out, vx_out, vy_out, vz_out, out, xch, flags, rcv_rows, order,
        rcv_starts, n, s, src_cell, tracks, rcv_cell, k1, k2, absorb,
        out_scale, starts, blocks, static_cast<cudaStream_t>(stream));
}

extern "C" int fdtd_prof_set(long long* buf) {
#ifdef FDTD_PROFILE
    return static_cast<int>(
        cudaMemcpyToSymbol(g_fdtd_prof, &buf, sizeof(buf)));
#else
    (void)buf;
    return static_cast<int>(cudaErrorInvalidValue);
#endif
}

// The grid-stride field kernel. p_in (n^3,), vx_in (n+1, n, n), vy_in (n,
// n+1, n), vz_in (n, n, n+1) read only; pa, pb and each velocity's a, b
// buffers scratch: after the block the fields are in the a buffers when
// s is even, the b buffers when odd. out (tracks, s); src_pre (1,)
// scratch; the receiver of row t is rcv_rows[t], or rcv_cell when
// rcv_rows is null. Returns the launch's error (0 on success).
extern "C" int old_field_launch(const float* src, const float* p_in,
                                const float* vx_in, const float* vy_in,
                                const float* vz_in, float* pa, float* pb,
                                float* vxa, float* vxb, float* vya,
                                float* vyb, float* vza, float* vzb,
                                float* out, float* src_pre,
                                const int* rcv_rows, int n, int s,
                                int src_cell, int tracks, int rcv_cell,
                                float k1, float k2, float absorb,
                                float out_scale, void* stream) {
    if (bad_shape(n, s, tracks, src_cell)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err;
    const int blocks = grid_blocks(old_field_kernel, 1LL * (n + 1) * n * n,
                                   &err);
    if (blocks == 0) return static_cast<int>(err);
    Grid g = make_grid(n, s, src_cell, tracks, rcv_cell, rcv_rows, k1, k2,
                       0.f, absorb, out_scale);
    void* args[] = {&g, &src, &p_in, &vx_in, &vy_in, &vz_in, &pa, &pb, &vxa,
                    &vxb, &vya, &vyb, &vza, &vzb, &out, &src_pre};
    err = cudaLaunchCooperativeKernel(
        (const void*)old_field_kernel, dim3(blocks),
        dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// The blocks the grid-stride field kernel's cooperative launch takes for
// an n^3 grid (0 when the device cannot launch it cooperatively): the
// grid whose barrier fdtd_sync_probe_launch measures.
extern "C" int old_field_blocks(int n) {
    cudaError_t err;
    return grid_blocks(old_field_kernel, 1LL * (n + 1) * n * n, &err);
}

// `syncs` grid-wide barriers alone, in one cooperative launch of `blocks`
// blocks of the kernels' size. Returns the launch's error (0 on success).
extern "C" int fdtd_sync_probe_launch(int syncs, int blocks, void* stream) {
    if (syncs < 0 || blocks <= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    void* args[] = {&syncs};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)fdtd_sync_probe_kernel, dim3(blocks), dim3(kThreads),
        args, 0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
