// K8: LB_KEOGH matrix, (Q, L) queries against (C, L) candidate envelopes
// -> (Q, C):  out[q, c] = sum_i max(q_i - u_ci, 0)^2 + max(lo_ci - q_i, 0)^2.
//
// Replaces src/repro/kernels/lb_keogh.py:lb_keogh_pallas (_lb_keogh_kernel).
// Bound on this card: FP32 operations, 5 per (q, c, i), the least a term
// needs (the clamp form: a max, a min, a subtract and one FFMA counted as
// two), against (Q + 2 C) L reads: at Q = 256, C = 16384, L = 512 that is
// ~10.7 GFLOP (0.160 ms at 67 TFLOP/s) against ~70 MB.  That peak counts
// an FFMA as two operations, and three of a term's four instructions are
// not FMAs, so the attainable floor is the issue rate: 128 FP32 lanes an
// SM a clock, at 4 instructions a term 0.257 ms at that shape on 132 SMs
// at 1.98 GHz.
//
// Design: the clamp form in register tiles, the body kg_tile in
// csrc/lb_keogh.cuh (shared with K2's full form, which runs it over the
// bridge columns): 128 x 64 output tiles, 8 x 4 outputs a thread, L in
// 32-column chunks copied by cp.async into two buffers, one partial sum a
// chunk, and a chunk vote that sends envelopes with !(lo <= u) to the
// reference's arithmetic (that header says why each).  Here the tile runs
// over every column, and each thread writes its 8 x 4 sums, only rows
// inside Q and C.  Two blocks an SM (<= 128 registers).
#include "lb_keogh.cuh"

__global__ void __launch_bounds__(KG_THREADS, 2)
lb_keogh_kernel(const float* __restrict__ q, const float* __restrict__ u,
                const float* __restrict__ lo, float* __restrict__ out, int Q,
                int C, int L) {
    extern __shared__ float4 kg_sm4[];
    kg_tile(q, u, lo, reinterpret_cast<float*>(kg_sm4), Q, C, L, 0, L,
            [&](const float (&acc)[8][4], int q0, int c0, int ty, int tx) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int gq = q0 + 64 * (i / 4) + 4 * ty + i % 4;
            if (gq >= Q) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int gc = c0 + 4 * tx + j;
                if (gc < C) out[(size_t)gq * C + gc] = acc[i][j];
            }
        }
    });
}

extern "C" int lb_keogh_launch(const float* q, const float* u,
                               const float* lo, float* out, int Q, int C,
                               int L, void* stream) {
    cudaError_t e = cudaFuncSetAttribute(
        lb_keogh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        KG_SMEM);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((C + KG_TC - 1) / KG_TC, (Q + KG_TQ - 1) / KG_TQ);
    lb_keogh_kernel<<<grid, KG_THREADS, KG_SMEM, (cudaStream_t)stream>>>(
        q, u, lo, out, Q, C, L);
    return (int)cudaGetLastError();
}
