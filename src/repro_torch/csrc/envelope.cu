// K1: Sakoe-Chiba upper/lower envelopes, max/min over [i - w, i + w].
//
// Replaces src/repro/kernels/envelope.py:envelope_pallas
// (_envelope_kernel).  One block per (series row, tile of ENV_TILE
// outputs); the tile and its +-w halo (clipped to the row) sit in shared
// memory, and each thread scans its output's window there.  Max and min
// are exact, so the result is bit-equal to the plain version in any
// order.  The work is O(L * (2w + 1)) comparisons per row from shared
// memory, against 12 bytes of device memory per element: for the
// cascade's windows (w ~ 0.1 L) the kernel stays near its memory bound.
#include "common.cuh"

#define ENV_TILE 1024
#define ENV_THREADS 256

__global__ void envelope_kernel(const float* __restrict__ b,
                                float* __restrict__ u,
                                float* __restrict__ lo, int L, int w) {
    extern __shared__ float s[];
    const int row = blockIdx.x;
    const int t0 = blockIdx.y * ENV_TILE;
    const int t1 = min(t0 + ENV_TILE, L);
    const int h0 = max(0, t0 - w);
    const int h1 = min(L, t1 + w);               // exclusive
    const float* br = b + (size_t)row * L;
    for (int i = h0 + threadIdx.x; i < h1; i += blockDim.x)
        s[i - h0] = br[i];
    __syncthreads();
    float* ur = u + (size_t)row * L;
    float* lr = lo + (size_t)row * L;
    for (int i = t0 + threadIdx.x; i < t1; i += blockDim.x) {
        const int j0 = max(0, i - w) - h0;
        const int j1 = min(L - 1, i + w) - h0;
        float mx = -RT_INF, mn = RT_INF;
        for (int j = j0; j <= j1; ++j) {
            const float x = s[j];
            mx = fmaxf(mx, x);
            mn = fminf(mn, x);
        }
        ur[i] = mx;
        lr[i] = mn;
    }
}

// Shared-memory bytes the launch needs for (L, w), or -1 when it exceeds
// the card's per-block limit.
extern "C" long long envelope_smem_bytes(int L, int w) {
    long long span = (long long)ENV_TILE + 2LL * w;
    if (span > L) span = L;
    long long bytes = span * 4;
    return bytes > RT_MAX_DYN_SMEM ? -1 : bytes;
}

extern "C" int envelope_launch(const float* b, float* u, float* lo, int n,
                               int L, int w, void* stream) {
    const long long smem = envelope_smem_bytes(L, w);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            envelope_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid(n, (L + ENV_TILE - 1) / ENV_TILE);
    envelope_kernel<<<grid, ENV_THREADS, (size_t)smem,
                      (cudaStream_t)stream>>>(b, u, lo, L, w);
    return (int)cudaGetLastError();
}
