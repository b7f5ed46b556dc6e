// K1: Sakoe-Chiba upper/lower envelopes, max/min over [i - w, i + w].
//
// Replaces src/repro/kernels/envelope.py:envelope_pallas
// (_envelope_kernel, which reduces with prefix doubling, O(L log w)).
// Van Herk / Gil-Werman: cut the row into segments of k = 2w + 1; g[i] is
// the max (min) from i's segment head to i, h[i] from i to its segment
// end.  A window [lo, hi] (clipped to the row) spans at most two
// segments, so U[i] = max(h[lo], g[hi]) -- or g[hi] alone when lo is a
// head, h[lo] alone when both lie in one segment that lo does not start
// (then hi is the row's end).  O(L) work per row for any w, and no
// shared memory that grows with w.
//
// A persistent grid of blocks loops over rows.  Each block keeps its
// row's g and h (max and min) in a device-memory scratch of (grid, 4, L)
// floats that the wrapper allocates; the block's own __syncthreads makes
// those writes visible to its threads, so the scratch is read with plain
// loads.  The scans: the row's segments are split into one contiguous run
// per warp, and a warp walks its run 32 elements at a time with a
// segmented shuffle scan (heads where i % k == 0 going forward, segment
// ends going backward) carrying the last lane's value.  Max and min are
// exact, so the result is bit-equal to the plain version.
//
// Bound on this card: memory, 12 bytes per element of device memory (read
// the series, write both envelopes); the scratch stays in L2 for rows of
// up to a few thousand elements.
#include "common.cuh"

#define ENV_THREADS 256
#define ENV_WARPS (ENV_THREADS / 32)

// Inclusive segmented scan of (max, min) over the 32 lanes: ``head`` marks
// a lane that starts a segment (nothing before it joins).  Returns whether
// a head lies at or before the lane.
__device__ __forceinline__ bool env_warp_scan(float& mx, float& mn,
                                              bool head, int lane) {
    bool f = head;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float pmx = __shfl_up_sync(0xffffffffu, mx, o);
        const float pmn = __shfl_up_sync(0xffffffffu, mn, o);
        const bool pf = __shfl_up_sync(0xffffffffu, (int)f, o) != 0;
        if (lane >= o && !f) {
            mx = fmaxf(mx, pmx);
            mn = fminf(mn, pmn);
        }
        if (lane >= o) f = f || pf;
    }
    return f;
}

__global__ void envelope_kernel(const float* __restrict__ b,
                                float* __restrict__ u,
                                float* __restrict__ lo, float* scratch,
                                long long n, int L, int w) {
    const int k = 2 * w + 1;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long nseg = (L + (long long)k - 1) / k;
    // this block's scratch: g max, g min, h max, h min
    float* gmx = scratch + (size_t)blockIdx.x * 4 * L;
    float* gmn = gmx + L;
    float* hmx = gmn + L;
    float* hmn = hmx + L;
    for (long long row = blockIdx.x; row < n; row += gridDim.x) {
        const float* br = b + (size_t)row * L;
        // this warp's run of whole segments [s0, s1), elements [e0, e1)
        const long long s0 = nseg * warp / ENV_WARPS;
        const long long s1 = nseg * (warp + 1) / ENV_WARPS;
        const int e0 = (int)min((long long)L, s0 * k);
        const int e1 = (int)min((long long)L, s1 * k);
        // forward: g = max/min from the segment head
        float cmx = -RT_INF, cmn = RT_INF;
        for (int c = e0; c < e1; c += 32) {
            const int i = c + lane;
            const bool in = i < e1;
            float mx = -RT_INF, mn = RT_INF;
            if (in) mx = mn = __ldg(br + i);
            const bool f = env_warp_scan(mx, mn, in && (i % k == 0), lane);
            if (!f) {
                mx = fmaxf(mx, cmx);
                mn = fminf(mn, cmn);
            }
            if (in) {
                gmx[i] = mx;
                gmn[i] = mn;
            }
            cmx = __shfl_sync(0xffffffffu, mx, 31);
            cmn = __shfl_sync(0xffffffffu, mn, 31);
        }
        // backward: h = max/min to the segment end (lane l takes element
        // e1 - 1 - (c + l), so lane order runs right to left)
        cmx = -RT_INF;
        cmn = RT_INF;
        for (int c = 0; c < e1 - e0; c += 32) {
            const int i = e1 - 1 - (c + lane);
            const bool in = i >= e0;
            float mx = -RT_INF, mn = RT_INF;
            if (in) mx = mn = __ldg(br + i);
            const bool end = in && (i % k == k - 1 || i == L - 1);
            const bool f = env_warp_scan(mx, mn, end, lane);
            if (!f) {
                mx = fmaxf(mx, cmx);
                mn = fminf(mn, cmn);
            }
            if (in) {
                hmx[i] = mx;
                hmn[i] = mn;
            }
            cmx = __shfl_sync(0xffffffffu, mx, 31);
            cmn = __shfl_sync(0xffffffffu, mn, 31);
        }
        __syncthreads();
        float* ur = u + (size_t)row * L;
        float* lr = lo + (size_t)row * L;
        for (int i = threadIdx.x; i < L; i += blockDim.x) {
            const int a0 = max(0, i - w);
            const int a1 = (int)min((long long)L - 1, (long long)i + w);
            float mx, mn;
            if (a0 / k != a1 / k) {
                mx = fmaxf(hmx[a0], gmx[a1]);
                mn = fminf(hmn[a0], gmn[a1]);
            } else if (a0 % k == 0) {
                mx = gmx[a1];
                mn = gmn[a1];
            } else {
                mx = hmx[a0];
                mn = hmn[a0];
            }
            ur[i] = mx;
            lr[i] = mn;
        }
        __syncthreads();                // the next row reuses the scratch
    }
}

extern "C" int envelope_launch(const float* b, float* u, float* lo,
                               float* scratch, int grid, long long n, int L,
                               int w, void* stream) {
    envelope_kernel<<<grid, ENV_THREADS, 0, (cudaStream_t)stream>>>(
        b, u, lo, scratch, n, L, w);
    return (int)cudaGetLastError();
}
