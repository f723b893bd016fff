// Speed-of-light kernels for Hopper (sm_90a), bound through a plain C
// interface (gpuaudiobench_tpu_torch/utils/build.py loads it with ctypes).
// Their achieved rates are the measured denominators of the port's roofline
// (gpuaudiobench_tpu_torch/calibrate_peaks.py). Both run k dependent passes
// of y <- y * m + c on every element of a (rows, width) f32 array, each pass
// one __fmaf_rn (one rounding), so both match the closed form
// x * m^k + c * (1 - m^k) / (1 - m) and each other bit for bit. m and c are
// kernel arguments and the file is built without --use_fast_math, so the
// compiler can neither fold nor reassociate the chain. Any rows x width is
// taken; each kernel masks its own ragged edge.
//
// fma_chain replaces gpuaudiobench_tpu/ops/speedoflight.py:_fma_kernel
// (reached through fma_chain_pallas, 32-row VMEM blocks on the TPU).
//   What bounds it: FP32 FMA issue. 2 FLOP per element and pass, 8 bytes an
//   element moved once: at the default 8 MiB and k = 512, 2.15 GFLOP against
//   16.8 MB, 0.0321 ms at 67 TFLOP/s against 0.0050 ms at 3.35 TB/s
//   (NVIDIA H100 SXM data sheet at 700 W).
//   What the design does about it: an SM issues 128 FFMA a clock, 32 per
//   scheduler, and an FFMA's result is ready 4 clocks later. Each thread
//   holds 8 independent elements in registers (8 chains in flight a warp),
//   256 threads a block, so 2,097,152 elements are 1,024 blocks: one wave
//   at 8 blocks on each of the 132 SMs. The pass loop is unrolled by 16, so
//   the loop's own compare and branch are 1 instruction in 128 FFMAs.
//
// fma_vmem replaces gpuaudiobench_tpu/ops/speedoflight.py:_fma_vmem_kernel
// (reached through fma_vmem_pallas, the carry through VMEM on every pass).
//   What bounds it: the shared-memory pass rate. Every pass loads and stores
//   each element of the tile once (8 B an element and pass): at the default
//   2 MiB and k = 512, 2.15 GB, 0.064 ms at 132 SMs x 128 B a clock x
//   1.98 GHz = 33.4 TB/s (an estimate; no data sheet gives it). Its FMAs
//   alone take 0.0080 ms at 67 TFLOP/s.
//   What the design does about it: a block of 256 threads loads a tile of
//   1,024 elements (4 KB of dynamic shared memory) and runs the k passes
//   there, a __syncthreads() between passes. In pass p thread t takes the
//   float4 (t + 8 p) mod 256 of the tile: one LDS.128, four FMAs, one
//   STS.128. The owner rotates by 8 float4s (a warp's 32 floats) each pass,
//   so no carry can stay in a register, while a warp still reads 512
//   consecutive bytes (the fewest shared-memory wavefronts, no bank
//   conflict). A float4 a thread keeps the address arithmetic to a few
//   instructions a pass; with a scalar load, FMA and store an element, ~10
//   instructions an element, instruction issue and not the shared-memory
//   pipe would be the limit.
//   2 MiB are 512 blocks, 4 on most SMs (32 warps each), so one block's
//   barrier overlaps the others' traffic. A tile shorter than 1,024 (the
//   ragged end) takes a scalar path: 4 elements a thread, rotated by 32.

#include <cuda_runtime.h>

namespace {

constexpr int kChainThreads = 256;
constexpr int kChainPerThread = 8;   // independent chains a thread
constexpr int kChainUnroll = 16;     // passes a loop trip
constexpr int kVmemThreads = 256;
constexpr int kVmemPerThread = 4;
constexpr int kVmemTile = kVmemThreads * kVmemPerThread;  // 1,024 floats
constexpr int kVmemRotate = 32;      // a warp: the owner's shift a pass

__global__ void __launch_bounds__(kChainThreads)
fma_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long n, int k, float m, float c) {
    const long long base =
        static_cast<long long>(blockIdx.x) * (kChainThreads * kChainPerThread)
        + threadIdx.x;
    float y[kChainPerThread];
#pragma unroll
    for (int j = 0; j < kChainPerThread; ++j) {
        const long long i = base + static_cast<long long>(j) * kChainThreads;
        y[j] = i < n ? x[i] : 0.0f;
    }
    int pass = 0;
    for (; pass + kChainUnroll <= k; pass += kChainUnroll) {
#pragma unroll
        for (int u = 0; u < kChainUnroll; ++u) {
#pragma unroll
            for (int j = 0; j < kChainPerThread; ++j) {
                y[j] = __fmaf_rn(y[j], m, c);
            }
        }
    }
    for (; pass < k; ++pass) {
#pragma unroll
        for (int j = 0; j < kChainPerThread; ++j) {
            y[j] = __fmaf_rn(y[j], m, c);
        }
    }
#pragma unroll
    for (int j = 0; j < kChainPerThread; ++j) {
        const long long i = base + static_cast<long long>(j) * kChainThreads;
        if (i < n) out[i] = y[j];
    }
}

__global__ void __launch_bounds__(kVmemThreads)
fma_vmem_kernel(const float* __restrict__ x, float* __restrict__ out,
                long long n, int k, float m, float c) {
    extern __shared__ float4 tile4[];
    float* tile = reinterpret_cast<float*>(tile4);
    const long long base = static_cast<long long>(blockIdx.x) * kVmemTile;
    const int len = static_cast<int>(
        n - base < kVmemTile ? n - base : kVmemTile);
    const int tid = threadIdx.x;
    for (int i = tid; i < len; i += kVmemThreads) tile[i] = x[base + i];
    __syncthreads();
    if (len == kVmemTile) {
        constexpr int kVecs = kVmemTile / 4;
        int rot = 0;
        for (int pass = 0; pass < k; ++pass) {
            const int e = (tid + rot) & (kVecs - 1);
            float4 v = tile4[e];
            v.x = __fmaf_rn(v.x, m, c);
            v.y = __fmaf_rn(v.y, m, c);
            v.z = __fmaf_rn(v.z, m, c);
            v.w = __fmaf_rn(v.w, m, c);
            tile4[e] = v;
            rot = (rot + kVmemRotate / 4) & (kVecs - 1);
            __syncthreads();
        }
    } else {
        const int step = kVmemRotate % len;
        int rot = 0;
        for (int pass = 0; pass < k; ++pass) {
            int e[kVmemPerThread];
            float v[kVmemPerThread];
#pragma unroll
            for (int j = 0; j < kVmemPerThread; ++j) {
                const int i = tid + j * kVmemThreads;
                e[j] = i + rot >= len ? i + rot - len : i + rot;
                v[j] = i < len ? tile[e[j]] : 0.0f;
            }
#pragma unroll
            for (int j = 0; j < kVmemPerThread; ++j) {
                v[j] = __fmaf_rn(v[j], m, c);
            }
#pragma unroll
            for (int j = 0; j < kVmemPerThread; ++j) {
                if (tid + j * kVmemThreads < len) tile[e[j]] = v[j];
            }
            rot = rot + step >= len ? rot + step - len : rot + step;
            __syncthreads();
        }
    }
    for (int i = tid; i < len; i += kVmemThreads) out[base + i] = tile[i];
}

}  // namespace

extern "C" {

// x and out: n contiguous float32 (rows x width), n >= 1, k >= 0. Each
// returns cudaGetLastError() after the launch (0 on success).
int fma_chain_launch(const float* x, float* out, long long n, int k, float m,
                     float c, void* stream) {
    if (n <= 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long per_block = kChainThreads * kChainPerThread;
    const long long blocks = (n + per_block - 1) / per_block;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    fma_chain_kernel<<<static_cast<unsigned>(blocks), kChainThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, out, n, k, m,
                                                            c);
    return static_cast<int>(cudaGetLastError());
}

int fma_vmem_launch(const float* x, float* out, long long n, int k, float m,
                    float c, void* stream) {
    if (n <= 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (n + kVmemTile - 1) / kVmemTile;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    fma_vmem_kernel<<<static_cast<unsigned>(blocks), kVmemThreads,
                      kVmemTile * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(x, out, n, k, m,
                                                           c);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
