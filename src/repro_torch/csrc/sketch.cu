// K7: tier-(-1) int8 sketch bound in scaled units,
//   out[q, n] = sum_j wseg[j] * max(qs[q, j] - hi[n, j], lo[n, j] - qs[q, j], 0)^2
// for (Q, S) f32 query means qs (already divided by the store's scale),
// (N, S) int8 sk_lo / sk_hi and the (S,) weights wseg = n_j * scale^2.
//
// Replaces src/repro/kernels/sketch.py:sketch_bound_pallas (_sketch_kernel).
// One thread per candidate column n (SK_THREADS candidates per block), one
// block row per tile of SK_QT queries (grid.y covers any Q).  The block's
// (SK_QT, S) query tile and the S weights sit in shared memory; each thread
// reads its candidate's int8 cells 16 at a time (one 16-byte load for each
// of lo and hi when the row is 16-byte aligned), converts them to f32 in
// registers and keeps one accumulator per query of the tile.  out[q, n] is
// written with n contiguous across the warp.
//
// Bound on this card: the 4 Q N bytes of output against ~6 FP32 operations
// per (q, n, j): at S = 16 both are of the same order, and the design keeps
// every store coalesced and every input byte read once per query tile.
//
// Arithmetic: per (q, n) the segments are summed in the order j = 0..S-1 as
// acc + (wseg_j * d) * d with every product and sum rounded on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), the order of the plain
// version kernels/ref.py:sketch_bound_scaled, so the two are bit-equal.
#include "common.cuh"

#include <stdint.h>

#define SK_THREADS 128
#define SK_QT 32
#define SK_CHUNK 16
#define SK_MAX_S 256

__global__ void sketch_bound_kernel(const float* __restrict__ qs,
                                    const int8_t* __restrict__ lo,
                                    const int8_t* __restrict__ hi,
                                    const float* __restrict__ wseg,
                                    float* __restrict__ out, int Q, int N,
                                    int S, int aligned) {
    extern __shared__ float sh[];
    float* w_sh = sh;                       // (S,)
    float* q_sh = sh + S;                   // (SK_QT, S)
    const int q0 = blockIdx.y * SK_QT;
    const int nq = min(SK_QT, Q - q0);
    for (int i = threadIdx.x; i < S; i += blockDim.x) w_sh[i] = wseg[i];
    for (int i = threadIdx.x; i < nq * S; i += blockDim.x)
        q_sh[i] = qs[(size_t)q0 * S + i];
    __syncthreads();
    const long long n = (long long)blockIdx.x * SK_THREADS + threadIdx.x;
    if (n >= N) return;
    const int8_t* lr = lo + n * S;
    const int8_t* hr = hi + n * S;
    float acc[SK_QT];
#pragma unroll
    for (int t = 0; t < SK_QT; ++t) acc[t] = 0.f;
    for (int j0 = 0; j0 < S; j0 += SK_CHUNK) {
        const int nj = min(SK_CHUNK, S - j0);
        float lf[SK_CHUNK], hf[SK_CHUNK];
        if (aligned && nj == SK_CHUNK) {
            const int4 lv = *reinterpret_cast<const int4*>(lr + j0);
            const int4 hv = *reinterpret_cast<const int4*>(hr + j0);
            const int8_t* lb = reinterpret_cast<const int8_t*>(&lv);
            const int8_t* hb = reinterpret_cast<const int8_t*>(&hv);
#pragma unroll
            for (int j = 0; j < SK_CHUNK; ++j) {
                lf[j] = (float)lb[j];
                hf[j] = (float)hb[j];
            }
        } else {
#pragma unroll
            for (int j = 0; j < SK_CHUNK; ++j) {
                lf[j] = j < nj ? (float)lr[j0 + j] : 0.f;
                hf[j] = j < nj ? (float)hr[j0 + j] : 0.f;
            }
        }
#pragma unroll
        for (int t = 0; t < SK_QT; ++t) {
            if (t < nq) {
                const float* qr = q_sh + t * S + j0;
                float a = acc[t];
#pragma unroll
                for (int j = 0; j < SK_CHUNK; ++j) {
                    if (j < nj) {
                        const float qv = qr[j];
                        const float d = fmaxf(fmaxf(__fsub_rn(qv, hf[j]),
                                                    __fsub_rn(lf[j], qv)),
                                              0.f);
                        a = __fadd_rn(a, __fmul_rn(__fmul_rn(w_sh[j0 + j], d),
                                                   d));
                    }
                }
                acc[t] = a;
            }
        }
    }
#pragma unroll
    for (int t = 0; t < SK_QT; ++t)
        if (t < nq) out[(size_t)(q0 + t) * N + n] = acc[t];
}

// Shared-memory bytes a block needs for S segments, or -1 when S exceeds
// what the kernel takes.
extern "C" long long sketch_bound_smem_bytes(int S) {
    if (S < 1 || S > SK_MAX_S) return -1;
    return (long long)(SK_QT + 1) * S * 4;
}

extern "C" int sketch_bound_launch(const float* qs, const int8_t* lo,
                                   const int8_t* hi, const float* wseg,
                                   float* out, int Q, int N, int S,
                                   void* stream) {
    const long long smem = sketch_bound_smem_bytes(S);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    const int aligned = (S % SK_CHUNK == 0)
        && ((reinterpret_cast<uintptr_t>(lo) | reinterpret_cast<uintptr_t>(hi))
            % 16 == 0);
    dim3 grid((N + SK_THREADS - 1) / SK_THREADS, (Q + SK_QT - 1) / SK_QT);
    sketch_bound_kernel<<<grid, SK_THREADS, (size_t)smem,
                          (cudaStream_t)stream>>>(qs, lo, hi, wseg, out, Q,
                                                  N, S, aligned);
    return (int)cudaGetLastError();
}
