// K4: banded DTW with row-block abandon against a per-pair cutoff,
// (P, L) x (P, L) -> (P,).
//
// Replaces src/repro/kernels/dtw_band.py:dtw_band_pallas
// (_dtw_band_kernel_blocked, operand packing _pack_band_operands), whose
// recurrence is src/repro/core/dtw.py:band_step.  One block per pair,
// threads over the 2wb+1 diagonal offsets k of the band-packed state:
//
//   S_d[k] = cost(i, j) + min(S_{d-1}[k-1], S_{d-1}[k+1], S_{d-2}[k])
//
// with i = (d + k - wb) / 2, j = (d - k + wb) / 2 (cells exist where
// d + k - wb is even).  S_{d-1} and S_{d-2} live in shared memory; S_d
// overwrites S_{d-2} in place, since each k reads only its own S_{d-2}[k],
// so one __syncthreads separates two anti-diagonals.  The series are read
// straight from device memory (each row once into L1), which is what the
// Pallas kernel's host-side 2x-duplicated packing did in VMEM.
//
// Abandon: exactly the JAX rule.  At a row-block boundary
// ((d + 1) % R == 0 or d == D - 1) a block-wide minimum of
// min(S_d, S_{d-1}) is tested against the pair's cutoff; strictly greater
// means dead, and a dead pair writes +inf and its block exits -- the GPU
// form of "a tile whose lanes are all dead skips its remaining blocks",
// at a granularity of one pair.  A -inf cutoff (an invalid slot) always
// dies at the first boundary, so it exits before the sweep.
//
// Bound on this card: ~5 FP32 operations per band cell, L(2w+1) - w(w+1)
// cells per pair, against 8 L bytes per pair: operation-bound.  The cell
// update uses __fmul_rn / __fadd_rn so nvcc cannot contract it into an
// FMA, which keeps the kernel bit-equal to the plain version.
#include "common.cuh"

__global__ void dtw_band_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                const float* __restrict__ cutoff,
                                float* __restrict__ out, int L, int wb,
                                int R) {
    extern __shared__ float sm[];
    __shared__ float red[32];
    const int p = blockIdx.x;
    const int Wb = 2 * wb + 1;
    const float cut = cutoff[p];
    if (cut == -RT_INF) {
        if (threadIdx.x == 0) out[p] = RT_INF;
        return;
    }
    const float* ap = a + (size_t)p * L;
    const float* bp = b + (size_t)p * L;
    float* S1 = sm;                 // S_{d-1}
    float* S2 = sm + Wb;            // S_{d-2}, overwritten by S_d
    for (int k = threadIdx.x; k < Wb; k += blockDim.x) {
        S1[k] = RT_INF;
        S2[k] = RT_INF;
    }
    __syncthreads();
    const int D = 2 * L - 1;
    const int last = 2 * L - 2;
    for (int d = 0; d < D; ++d) {
        const bool check = ((d + 1) % R == 0) || (d == D - 1);
        float fmin = RT_INF;
        for (int k = threadIdx.x; k < Wb; k += blockDim.x) {
            const int t = d + k - wb;           // 2i
            const int s = d - k + wb;           // 2j
            float nd = RT_INF;
            if (((t & 1) == 0) && t >= 0 && t <= last && s >= 0 && s <= last) {
                const float diff = __fsub_rn(__ldg(ap + (t >> 1)),
                                             __ldg(bp + (s >> 1)));
                const float cost = __fmul_rn(diff, diff);
                float best;
                if (d == 0 && k == wb) {
                    best = 0.f;                 // the path's origin
                } else {
                    const float l = k > 0 ? S1[k - 1] : RT_INF;
                    const float r = k < Wb - 1 ? S1[k + 1] : RT_INF;
                    best = fminf(fminf(l, r), S2[k]);
                }
                nd = __fadd_rn(cost, best);
            }
            if (check) fmin = fminf(fmin, fminf(nd, S1[k]));
            S2[k] = nd;
        }
        __syncthreads();
        float* tmp = S1;
        S1 = S2;
        S2 = tmp;
        if (check && rt_block_min(fmin, red) > cut) {
            if (threadIdx.x == 0) out[p] = RT_INF;
            return;
        }
    }
    if (threadIdx.x == 0) out[p] = S1[wb];
}

// Dynamic shared-memory bytes for half-width wb, or -1 when the two band
// buffers do not fit a block.
extern "C" long long dtw_band_smem_bytes(int wb) {
    const long long bytes = 2LL * (2LL * wb + 1) * 4;
    return bytes > RT_MAX_DYN_SMEM - 1024 ? -1 : bytes;
}

extern "C" int dtw_band_launch(const float* a, const float* b,
                               const float* cutoff, float* out, int P,
                               int L, int wb, int R, void* stream) {
    const long long smem = dtw_band_smem_bytes(wb);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            dtw_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    int threads = ((2 * wb + 1 + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    dtw_band_kernel<<<P, threads, (size_t)smem, (cudaStream_t)stream>>>(
        a, b, cutoff, out, L, wb, R);
    return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
