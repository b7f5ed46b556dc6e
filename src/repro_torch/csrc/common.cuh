// Shared helpers of the repro_torch kernels (plain C interface, loaded
// with ctypes by kernels/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define RT_INF CUDART_INF_F

// Block-wide minimum; every thread gets the result.  ``red`` holds one
// float per warp.  blockDim.x must be a multiple of 32.
__device__ __forceinline__ float rt_block_min(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1)
        v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    float r = RT_INF;
    const int nw = blockDim.x >> 5;
    for (int i = 0; i < nw; ++i) r = fminf(r, red[i]);
    __syncthreads();                    // red is reused by the next call
    return r;
}

__device__ __forceinline__ float rt_sq_diff(float a, float b) {
    const float d = a - b;
    return d * d;
}

// LB_ENHANCED's elastic bands for one (query row, candidate row) pair: the
// nb left and nb right L-shaped band minima, summed in the one fixed order
// of core/lower_bounds.py (left bands 0..nb-1 from zero, right bands
// likewise, then left + right), so every kernel that uses it is bit-equal
// to the plain version.  The squares are not fused into the sums: each
// passes through a min first.
__device__ __forceinline__ float rt_band_sum(const float* __restrict__ qr,
                                             const float* __restrict__ cr,
                                             int L, int nb) {
    float left = 0.f, right = 0.f;
    for (int bi = 0; bi < nb; ++bi) {
        float m = RT_INF;
        for (int t = 0; t <= bi; ++t) {
            const int j = bi - t;
            m = fminf(m, fminf(rt_sq_diff(qr[j], cr[bi]),
                               rt_sq_diff(qr[bi], cr[j])));
        }
        left = left + m;
    }
    for (int bi = 0; bi < nb; ++bi) {
        const int i = L - 1 - bi;
        float m = RT_INF;
        for (int t = 0; t <= bi; ++t) {
            const int j = i + t;
            m = fminf(m, fminf(rt_sq_diff(qr[j], cr[i]),
                               rt_sq_diff(qr[i], cr[j])));
        }
        right = right + m;
    }
    return left + right;
}
