// K4: banded DTW with row-block abandon against a per-pair cutoff,
// (P, L) x (P, L) -> (P,), its band state in shared memory.  K6 is the
// same kernel body with the per-step abandon form (PER_STEP); K5
// (csrc/dtw_band_stream.cu) is the same body with the state off chip.
// The body and its rules are in csrc/dtw_band.cuh.
//
// K4 replaces src/repro/kernels/dtw_band.py:dtw_band_pallas
// (_dtw_band_kernel_blocked, operand packing _pack_band_operands): one
// block per pair, threads over the valid cells of each anti-diagonal,
// S_{d-1} and S_{d-2} in shared memory.  A dead pair's block exits -- the
// GPU form of "a tile whose lanes are all dead skips its remaining
// blocks", at a granularity of one pair.  The series are read straight
// from device memory, which is what the Pallas kernel's host-side
// 2x-duplicated packing did in VMEM.
//
// K6 replaces src/repro/kernels/dtw_band.py:_dtw_band_kernel (the
// early_exit=False sweep), the baseline K4's block skipping is measured
// against.  Its plain version is core.dtw.dtw_band_blocked(...,
// row_block=1).
//
// Bound on this card: against 8 L bytes per pair, 5 FP32 operations per
// band cell (a subtract, a multiply, two mins, an add) over
// L(2w+1) - w(w+1) cells per pair for K4, 6 for K6 (one more min per cell
// into the frontier it tests every anti-diagonal): operation-bound.
#include "dtw_band.cuh"

// The two band buffers take 2 (2 wb + 1) 4 bytes of dynamic shared
// memory.  kernels/dtw_band.py:dtw_band_route is the one place that
// decides whether they fit (past it the band runs in K5); a band too wide
// for the card fails here in cudaFuncSetAttribute.
template <bool PER_STEP>
static int resident_launch(const float* a, const float* b,
                           const float* cutoff, float* out, int P, int L,
                           int wb, int R, void* stream) {
    const long long smem = 2LL * (2LL * wb + 1) * 4;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            dtw_band_kernel<PER_STEP, false>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dtw_band_kernel<PER_STEP, false>
        <<<P, dtw_band_threads(wb), (size_t)smem, (cudaStream_t)stream>>>(
            a, b, cutoff, out, nullptr, P, L, wb, R);
    return (int)cudaGetLastError();
}

extern "C" int dtw_band_launch(const float* a, const float* b,
                               const float* cutoff, float* out, int P,
                               int L, int wb, int R, void* stream) {
    return resident_launch<false>(a, b, cutoff, out, P, L, wb, R, stream);
}

extern "C" int dtw_band_step_launch(const float* a, const float* b,
                                    const float* cutoff, float* out, int P,
                                    int L, int wb, void* stream) {
    return resident_launch<true>(a, b, cutoff, out, P, L, wb, 1, stream);
}

extern "C" const char* rt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
