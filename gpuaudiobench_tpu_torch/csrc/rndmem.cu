// Random-memory (granular) gather for Hopper (sm_90a), bound through a
// plain C interface (gpuaudiobench_tpu_torch/utils/build.py loads it with
// ctypes).
//
// Replaces gpuaudiobench_tpu/ops/rndmem_pallas.py:_rndmem_kernel (reached
// through rndmem_gather_pallas). Each track t copies S contiguous samples
// of a large pool from its playhead into an interleaved output:
//     out[i, t] = pool[start(t) + i],  i < S,  out (S, T), flat T*i + t
// where start(t) follows jax.lax.dynamic_slice, as the JAX rndmem_gather
// does: a negative playhead counts from the end (P is added once), then
// the start is clamped to [0, P - S]. (The Pallas kernel does not clamp;
// it relies on POOL_PAD tail slack in the pool instead.) start + i is
// computed in 64 bits, so a pool above 2^31 samples cannot wrap.
//
// What bounds it: bytes. Every output sample is one pool read and one
// write: 2 * T * S * 4 bytes, 268 MB (0.080 ms at 3.35 TB/s) at 65,536
// tracks x 512 samples; there is no arithmetic. The windows start at
// random, unaligned offsets, so the reads cannot all be aligned, and the
// output is the transpose of the windows. The TPU kernel pipelined one DMA
// per track into VMEM and cut the windows out with lane gathers; here the
// transpose goes through shared memory:
//   * A block of 8 warps takes 32 tracks x 128 samples. Each warp reads
//     whole windows: lane l reads sample i0 + l + 32k of one track, so a
//     warp's loads are 128 consecutive bytes (two sectors when unaligned).
//   * The block then writes the tile transposed: lane l stores track
//     t0 + l of one output row, 128 consecutive bytes per warp store.
//   * The tile's rows are padded by one word, so the transposed reads from
//     shared memory hit 32 different banks.
// Ragged T and S are masked here.

#include <cuda_runtime.h>

namespace {

constexpr int kTracks = 32;  // tracks per block: one per lane on the store
constexpr int kWarps = 8;
constexpr int kTileS = 128;  // samples per block

__global__ void __launch_bounds__(kTracks * kWarps)
rndmem_gather_kernel(const float* __restrict__ pool,
                     const int* __restrict__ playheads,
                     float* __restrict__ out,
                     long long pool_len, int tracks, int s) {
    __shared__ float tile[kTracks][kTileS + 1];
    const int lane = threadIdx.x;
    const int warp = threadIdx.y;
    const int t0 = blockIdx.x * kTracks;
    const int i0 = blockIdx.y * kTileS;
    const int n = min(kTileS, s - i0);

    for (int k = warp; k < kTracks; k += kWarps) {
        const int t = t0 + k;
        if (t >= tracks) break;
        long long start = playheads[t];
        if (start < 0) start += pool_len;
        start = start < 0 ? 0 : start;
        start = start > pool_len - s ? pool_len - s : start;
        const float* src = pool + start + i0;
        for (int j = lane; j < n; j += 32) tile[k][j] = src[j];
    }
    __syncthreads();

    const int t = t0 + lane;
    if (t >= tracks) return;
    for (int r = warp; r < n; r += kWarps) {
        out[static_cast<long long>(i0 + r) * tracks + t] = tile[lane][r];
    }
}

}  // namespace

extern "C" {

// pool (pool_len,) float32, playheads (tracks,) int32, out (s, tracks)
// float32, all contiguous; s <= pool_len. Returns cudaGetLastError() after
// the launch (0 on success).
int rndmem_gather_launch(const float* pool, const int* playheads, float* out,
                         long long pool_len, int tracks, int s, void* stream) {
    if (tracks <= 0 || s <= 0 || pool_len < s) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const unsigned tiles = static_cast<unsigned>((s + kTileS - 1) / kTileS);
    if (tiles > 65535u) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>((tracks + kTracks - 1) / kTracks),
                    tiles);
    const dim3 block(32, kWarps);
    rndmem_gather_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        pool, playheads, out, pool_len, tracks, s);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
