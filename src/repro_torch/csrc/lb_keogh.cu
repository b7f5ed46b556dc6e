// K8: LB_KEOGH matrix, (Q, L) queries against (C, L) candidate envelopes
// -> (Q, C):  out[q, c] = sum_i max(q_i - u_ci, 0)^2 + max(lo_ci - q_i, 0)^2.
//
// Replaces src/repro/kernels/lb_keogh.py:lb_keogh_pallas (_lb_keogh_kernel).
// Bound on this card: FP32 operations, ~6 per (q, c, i) (two subtracts, two
// maxes, two squares folded into the sum), against (Q + 2 C) L reads: at
// Q = 256, C = 16384, L = 512 that is ~12.9 GFLOP against ~70 MB.  Design:
// a block computes a (KG_TQ x KG_TC) output tile and walks L in chunks of
// KG_K columns, the way a GEMM walks its k-loop: each chunk stages the
// tile's query rows and the two envelope rows of its candidates in shared
// memory (coalesced along L), and each thread accumulates KG_TQ / KG_TY
// outputs of one candidate column in registers.  Ragged edges (Q, C or L
// not a multiple of the tile) are masked here; nothing is padded in device
// memory.
//
// Each thread sums a chunk's KG_K terms and adds the chunk's sum to its
// running total, an order other than the plain version's reduction: the
// two agree to rtol 1e-5, not bit for bit.
#include "common.cuh"

#define KG_TQ 32
#define KG_TC 32
#define KG_K 32
#define KG_TY 8                           // threads per column (blockDim.y)
#define KG_RQ (KG_TQ / KG_TY)             // outputs per thread

__global__ void lb_keogh_kernel(const float* __restrict__ q,
                                const float* __restrict__ u,
                                const float* __restrict__ lo,
                                float* __restrict__ out, int Q, int C,
                                int L) {
    __shared__ float q_sh[KG_TQ][KG_K + 1];
    __shared__ float u_sh[KG_TC][KG_K + 1];
    __shared__ float l_sh[KG_TC][KG_K + 1];
    const int tx = threadIdx.x;           // candidate column in the tile
    const int ty = threadIdx.y;
    const int tid = ty * KG_TC + tx;
    const int q0 = blockIdx.y * KG_TQ;
    const int c0 = blockIdx.x * KG_TC;
    float acc[KG_RQ];
#pragma unroll
    for (int r = 0; r < KG_RQ; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < L; k0 += KG_K) {
        // stage the chunk: KG_TQ + 2 KG_TC rows of KG_K columns
        for (int e = tid; e < KG_TQ * KG_K; e += KG_TC * KG_TY) {
            const int r = e / KG_K, k = e % KG_K;
            const int gq = q0 + r, gk = k0 + k;
            q_sh[r][k] = (gq < Q && gk < L) ? q[(size_t)gq * L + gk] : 0.f;
        }
        for (int e = tid; e < KG_TC * KG_K; e += KG_TC * KG_TY) {
            const int r = e / KG_K, k = e % KG_K;
            const int gc = c0 + r, gk = k0 + k;
            const bool in = gc < C && gk < L;
            u_sh[r][k] = in ? u[(size_t)gc * L + gk] : 0.f;
            l_sh[r][k] = in ? lo[(size_t)gc * L + gk] : 0.f;
        }
        __syncthreads();
        const int nk = min(KG_K, L - k0);
        float part[KG_RQ];
#pragma unroll
        for (int r = 0; r < KG_RQ; ++r) part[r] = 0.f;
        for (int k = 0; k < nk; ++k) {
            const float uv = u_sh[tx][k];
            const float lv = l_sh[tx][k];
#pragma unroll
            for (int r = 0; r < KG_RQ; ++r) {
                const float qv = q_sh[ty + r * KG_TY][k];
                const float over = fmaxf(qv - uv, 0.f);
                const float under = fmaxf(lv - qv, 0.f);
                part[r] += over * over + under * under;
            }
        }
#pragma unroll
        for (int r = 0; r < KG_RQ; ++r) acc[r] += part[r];
        __syncthreads();
    }
    const int c = c0 + tx;
    if (c >= C) return;
#pragma unroll
    for (int r = 0; r < KG_RQ; ++r) {
        const int gq = q0 + ty + r * KG_TY;
        if (gq < Q) out[(size_t)gq * C + c] = acc[r];
    }
}

extern "C" int lb_keogh_launch(const float* q, const float* u,
                               const float* lo, float* out, int Q, int C,
                               int L, void* stream) {
    dim3 grid((C + KG_TC - 1) / KG_TC, (Q + KG_TQ - 1) / KG_TQ);
    dim3 block(KG_TC, KG_TY);
    lb_keogh_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(q, u, lo, out,
                                                              Q, C, L);
    return (int)cudaGetLastError();
}
