// K5: banded DTW with per-pair cutoffs whose band state lives in device
// memory, (P, L) x (P, L) -> (P,), for bands too wide for K4's shared
// memory (kernels/dtw_band.py:dtw_band_route: wb > 14463).  The kernel
// body, shared with K4 and K6, and its rules are in csrc/dtw_band.cuh.
//
// Replaces src/repro/kernels/dtw_band.py:_dtw_band_pallas_stream (body
// _dtw_band_kernel_stream), the TPU kernel that keeps the operands in HBM
// and double-buffers per-row-block windows into VMEM.  On the card the
// operands are read from device memory at any L already (K4 does so too);
// what no longer fits on chip is the band state, so that is what this
// kernel moves off chip.
//
// Design (simple first; a thread-block cluster holding the band in
// distributed shared memory is the planned redesign): a persistent grid
// of ~2 blocks per SM, up to 1024 threads each, loops over pairs; S_{d-1}
// and S_{d-2} sit in a device-memory scratch of (grid, 2, 2wb + 1) floats
// that the wrapper allocates.
//
// Bound on this card: 5 FP32 operations per band cell, L(2w+1) - w(w+1)
// cells per pair, against 8 L bytes per pair: operation-bound.  This
// design is bound in practice by the scratch traffic (three reads and a
// write per cell, mostly from L2) and one __syncthreads per
// anti-diagonal.
#include "dtw_band.cuh"

extern "C" int dtw_band_stream_launch(const float* a, const float* b,
                                      const float* cutoff, float* out,
                                      float* scratch, int grid,
                                      long long P, int L, int wb, int R,
                                      void* stream) {
    dtw_band_kernel<false, true>
        <<<grid, dtw_band_threads(wb), 0, (cudaStream_t)stream>>>(
            a, b, cutoff, out, scratch, P, L, wb, R);
    return (int)cudaGetLastError();
}
