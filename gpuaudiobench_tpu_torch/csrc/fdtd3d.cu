// 3-D FDTD room acoustics for Hopper (sm_90a): one block of S samples x 3
// substeps in one persistent cooperative launch, bound through a plain C
// interface (gpuaudiobench_tpu_torch/utils/build.py loads it with ctypes).
//
// Two kernels, each replacing one Pallas kernel of
// gpuaudiobench_tpu/ops/fdtd3d_pallas.py:
//   * fdtd_div_kernel replaces _fdtd_kernel_div (fdtd3d_block_pallas_div),
//     the production form. It carries (p, div v) on an N^3 grid; with the
//     velocity update substituted into the divergence, an interior cell
//     does
//         div' = (div + 6*k1*p) - k1 * (sum of the 6 neighbours' p)
//         p'   = p - k2 * div'
//     and a boundary cell p' = p * (1 - absorption). div' is zero off the
//     interior, which is what the JAX wrapper returns after its re-mask.
//   * fdtd_field_kernel replaces _fdtd_kernel (fdtd3d_block_pallas), the
//     field form with the staggered velocities vx (N+1, N, N), vy (N, N+1,
//     N), vz (N, N, N+1) (ops/fdtd3d.py:_fdtd_substep). It also serves the
//     per-track receivers, which the JAX package runs on XLA only.
// At the start of each sample the source cell gets src[n] (the sum of all
// tracks x 0.1, computed by the wrapper); after the sample's third
// substep every receiver row t reads out[t, n] = p[rcv(t)] * 0.1, from
// one broadcast receiver cell or from a cell per track.
//
// What bounds it: operations, and the grid-wide barrier. At room 50 (52^3
// cells, 50^3 interior) a div block is 1,536 substeps x (11 FLOP x 125,000
// interior cells + 1 x 15,608 boundary cells) = 2.1 GFLOP, 0.032 ms at 67
// TFLOP/s of FP32 (the field form about 16 FLOP a cell, 0.049 ms); the
// fields (0.56 MB each) stay in the 50 MB L2. Every substep reads the
// neighbours' p of the substep before,
// so the whole grid must meet 1,536 times per block; the JAX package runs
// the whole block in one launch, and so does this design:
//   * A cooperative launch (cudaLaunchCooperativeKernel) of at most the
//     blocks that fit on the card at once (occupancy x SMs); a launch that
//     is too large fails and the wrapper raises. Each thread walks its
//     cells in a grid stride, natural (x, y, z) order with z contiguous,
//     and owns the same cells in every substep.
//   * p ping-pongs between two buffers, so one cg::grid sync per substep
//     is enough; div (and in the field form the velocities, which also
//     ping-pong) is read and written by its owner only, or through the
//     buffers of the substep before. Reads of cells other threads wrote go
//     through L2 (__ldcg), never the non-coherent L1 or read-only caches.
//   * The source cell's owner adds src[n + 1] when it writes the last
//     substep of sample n (src[0] in the prologue, which copies the input
//     state). The receivers are read after the next barrier from the
//     buffer just written; if a receiver is the source cell it reads the
//     value from before the injection, kept aside by the owner.
//   * Each product, sum and difference is rounded on its own (__fmul_rn,
//     __fadd_rn, __fsub_rn), in the JAX expressions' order, so the kernel
//     gives the plain twin's bits.
// The barrier is this design's floor (PERF.md). Keeping both fields in the
// distributed shared memory of a thread-block cluster is left for later.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

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
fdtd_div_kernel(Grid g, const float* __restrict__ src,
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

// One face's velocity after the update v + (-k1) * (p_hi - p_lo).
__device__ __forceinline__ float face(float v, float p_hi, float p_lo,
                                      float k1) {
    return __fadd_rn(v, __fmul_rn(-k1, __fsub_rn(p_hi, p_lo)));
}

__global__ void __launch_bounds__(kThreads)
fdtd_field_kernel(Grid g, const float* __restrict__ src,
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

// Blocks of a cooperative launch of `kernel` that fit on the current
// device at once, capped at what `work` items need; 0 with *err set when
// the device cannot launch cooperatively.
template <typename K>
int grid_blocks(K kernel, long long work, cudaError_t* err) {
    int dev = 0, sms = 0, coop = 0, per_sm = 0;
    *err = cudaGetDevice(&dev);
    if (*err == cudaSuccess) {
        *err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    }
    if (*err == cudaSuccess) {
        *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (*err == cudaSuccess) {
        *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                             kThreads, 0);
    }
    if (*err != cudaSuccess) return 0;
    if (!coop || per_sm < 1) {
        *err = cudaErrorCooperativeLaunchTooLarge;
        return 0;
    }
    const long long need = (work + kThreads - 1) / kThreads;
    const long long fit = static_cast<long long>(per_sm) * sms;
    return static_cast<int>(need < fit ? need : fit);
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

}  // namespace

extern "C" {

// Divergence form. src (s,), p_in and div_in (n^3,) read only; pa, pb
// (n^3,) scratch: after the block p' is in pa when s is even, pb when odd;
// div (n^3,) receives div'; out (tracks, s), every row read from rcv_cell;
// src_pre (1,) scratch. Returns the launch's error (0 on success).
int fdtd_div_launch(const float* src, const float* p_in, const float* div_in,
                    float* pa, float* pb, float* div, float* out,
                    float* src_pre, int n, int s, int src_cell, int tracks,
                    int rcv_cell, float k1, float k2, float c6, float absorb,
                    float out_scale, void* stream) {
    if (bad_shape(n, s, tracks, src_cell)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err;
    const int blocks = grid_blocks(fdtd_div_kernel, 1LL * n * n * n, &err);
    if (blocks == 0) return static_cast<int>(err);
    Grid g = make_grid(n, s, src_cell, tracks, rcv_cell, nullptr, k1, k2, c6,
                       absorb, out_scale);
    void* args[] = {&g, &src, &p_in, &div_in, &pa, &pb, &div, &out, &src_pre};
    err = cudaLaunchCooperativeKernel(
        (const void*)fdtd_div_kernel, dim3(blocks),
        dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// Field form. p_in (n^3,), vx_in (n+1, n, n), vy_in (n, n+1, n), vz_in
// (n, n, n+1) read only; pa, pb and each velocity's a, b buffers scratch:
// after the block the fields are in the a buffers when s is even, the b
// buffers when odd. out and src_pre as for fdtd_div_launch; the receiver
// of row t is rcv_rows[t], or rcv_cell when rcv_rows is null.
int fdtd_field_launch(const float* src, const float* p_in, const float* vx_in,
                      const float* vy_in, const float* vz_in, float* pa,
                      float* pb, float* vxa, float* vxb, float* vya,
                      float* vyb, float* vza, float* vzb, float* out,
                      float* src_pre, const int* rcv_rows, int n, int s,
                      int src_cell, int tracks, int rcv_cell, float k1,
                      float k2, float absorb, float out_scale, void* stream) {
    if (bad_shape(n, s, tracks, src_cell)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err;
    const int blocks = grid_blocks(fdtd_field_kernel, 1LL * (n + 1) * n * n,
                                   &err);
    if (blocks == 0) return static_cast<int>(err);
    Grid g = make_grid(n, s, src_cell, tracks, rcv_cell, rcv_rows, k1, k2,
                       0.f, absorb, out_scale);
    void* args[] = {&g, &src, &p_in, &vx_in, &vy_in, &vz_in, &pa, &pb, &vxa,
                    &vxb, &vya, &vyb, &vza, &vzb, &out, &src_pre};
    err = cudaLaunchCooperativeKernel(
        (const void*)fdtd_field_kernel, dim3(blocks),
        dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// The blocks the divergence kernel's launch takes for an n^3 grid (0 when
// the device cannot launch it cooperatively).
int fdtd_div_blocks(int n) {
    cudaError_t err;
    return grid_blocks(fdtd_div_kernel, 1LL * n * n * n, &err);
}

// `syncs` grid-wide barriers alone, in one cooperative launch of `blocks`
// blocks of the kernels' size. Returns the launch's error (0 on success).
int fdtd_sync_probe_launch(int syncs, int blocks, void* stream) {
    if (syncs < 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&syncs};
    const cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)fdtd_sync_probe_kernel, dim3(blocks), dim3(kThreads),
        args, 0, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
