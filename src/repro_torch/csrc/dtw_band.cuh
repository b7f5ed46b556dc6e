// The banded-DTW kernel body of K4's and K6's block form
// (csrc/dtw_band.cu; run only when forced, as the same-call baseline of
// the slots form that k4_form picks for 255 < wb <= 14463) and of K5's
// scratch form (csrc/dtw_band_stream.cu, past wb = 231423 on a path):
// (P, L) x (P, L) -> (P,) with a per-pair
// cutoff.  Its recurrence is src/repro/core/dtw.py:band_step over the
// band-packed state, diagonal offsets k in [0, 2wb]:
//
//   S_d[k] = cost(i, j) + min(S_{d-1}[k-1], S_{d-1}[k+1], S_{d-2}[k])
//
// with i = (d + k - wb) / 2, j = (d - k + wb) / 2 (cells exist where
// d + k - wb is even).  S_d overwrites S_{d-2} in place, since each k reads
// only its own S_{d-2}[k], so one __syncthreads separates two
// anti-diagonals.  The series are read straight from device memory.
//
// STREAM says where the two band buffers live: in dynamic shared memory
// (K4's and K6's block form; the wrapper launches one block per pair) or
// in a device-memory scratch of (grid, 2, 2wb + 1) floats (K5; a
// persistent grid whose blocks loop over pairs), for bands too wide for a
// block's shared memory.
// The block that writes the scratch reads it back after a __syncthreads,
// through plain loads (never __ldg or a const __restrict__ pointer, whose
// non-coherent path could serve stale lines).
//
// Threads stride over the anti-diagonal's valid cells only -- k in
// [k_lo(d), k_hi(d)] of the parity with d + k - wb even.  The other slots
// are never written: a valid cell's three predecessors are either valid
// on their anti-diagonal or lie before the start of their diagonal line
// (each line k keeps one parity of d, so one buffer), whose slot still
// holds the +inf of the pair's initialisation.  Each thread keeps the
// minimum of the cells it wrote at d and at d - 1, so the block minimum
// covers exactly the valid cells of S_d and S_{d-1}, as the plain
// version's (whose other entries are +inf).
//
// PER_STEP says how a pair is abandoned.  K4 and K5 (false) follow the
// JAX rule exactly: at a row-block boundary ((d + 1) % R == 0 or
// d == D - 1) the block minimum of S_d and S_{d-1} is tested against the
// cutoff, strictly greater means dead, a dead pair writes +inf and the
// block moves to its next pair; a -inf cutoff (an invalid slot) returns
// +inf at once.  K6 (true) tests every anti-diagonal, poisons a dead
// pair's state to +inf and sweeps on to d = D - 1 with no early return, as
// src/repro/kernels/dtw_band.py:_dtw_band_kernel does; frontier minima
// only grow, so its outputs equal K4's.
//
// The cell update is unfused (__fsub_rn, __fmul_rn, __fadd_rn), so nvcc
// cannot contract it into an FMA and every instantiation is bit-equal to
// the plain version.  Pair and element offsets are 64-bit.
#pragma once

#include "common.cuh"

// Threads per block: the most valid cells of an anti-diagonal is wb + 1.
static inline int dtw_band_threads(int wb) {
    const int t = ((wb + 1 + 31) / 32) * 32;
    return t < 1024 ? t : 1024;
}

template <bool PER_STEP, bool STREAM>
__global__ void __launch_bounds__(1024)
dtw_band_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ cutoff, float* __restrict__ out,
                float* scratch, long long P, int L, int wb, int R) {
    extern __shared__ float sm[];
    __shared__ float red[32];
    const int Wb = 2 * wb + 1;
    const int D = 2 * L - 1;
    const int last = 2 * L - 2;
    float* base;
    if constexpr (STREAM) {
        base = scratch + (size_t)blockIdx.x * 2 * Wb;
    } else {
        base = sm;
    }
    for (long long p = blockIdx.x; p < P; p += gridDim.x) {
        const float cut = cutoff[p];
        if (!PER_STEP && cut == -RT_INF) {
            if (threadIdx.x == 0) out[p] = RT_INF;
            continue;
        }
        const float* ap = a + (size_t)p * L;
        const float* bp = b + (size_t)p * L;
        float* s1 = base;               // S_{d-1}
        float* s2 = base + Wb;          // S_{d-2}, overwritten by S_d
        for (int k = threadIdx.x; k < Wb; k += blockDim.x) {
            s1[k] = RT_INF;
            s2[k] = RT_INF;
        }
        __syncthreads();
        float fprev = RT_INF;           // min of this thread's S_{d-1} cells
        bool dead = false;
        for (int d = 0; d < D; ++d) {
            // cells of anti-diagonal d: 2i = d + k - wb and 2j = d - k + wb
            // in [0, 2L - 2], 2i even
            int k_lo = max(0, max(wb - d, d + wb - last));
            const int k_hi = min(2 * wb, min(d + wb, last - d + wb));
            k_lo += (d + k_lo - wb) & 1;
            float fcur = RT_INF;
            for (int k = k_lo + 2 * (int)threadIdx.x; k <= k_hi;
                 k += 2 * (int)blockDim.x) {
                const int i = (d + k - wb) >> 1;
                const int j = (d - k + wb) >> 1;
                const float diff = __fsub_rn(__ldg(ap + i), __ldg(bp + j));
                const float cost = __fmul_rn(diff, diff);
                float best;
                if (d == 0) {
                    best = 0.f;         // the path's origin, k == wb
                } else {
                    const float l = k > 0 ? s1[k - 1] : RT_INF;
                    const float r = k < 2 * wb ? s1[k + 1] : RT_INF;
                    best = fminf(fminf(l, r), s2[k]);
                }
                const float nd = __fadd_rn(cost, best);
                s2[k] = nd;
                fcur = fminf(fcur, nd);
            }
            __syncthreads();
            float* tmp = s1;
            s1 = s2;
            s2 = tmp;
            const bool check = PER_STEP || ((d + 1) % R == 0) || (d == D - 1);
            if (check && rt_block_min(fminf(fcur, fprev), red) > cut) {
                if constexpr (PER_STEP) {
                    // poison S_d and S_{d-1}; the sweep goes on through +inf
                    for (int k = threadIdx.x; k < Wb; k += blockDim.x) {
                        s1[k] = RT_INF;
                        s2[k] = RT_INF;
                    }
                    __syncthreads();
                    fcur = RT_INF;
                } else {
                    dead = true;
                    break;
                }
            }
            fprev = fcur;
        }
        if (threadIdx.x == 0) out[p] = dead ? RT_INF : s1[wb];
        __syncthreads();                // before the next pair's init
    }
}
