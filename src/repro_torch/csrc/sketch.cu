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
// of lo and hi), converts them to f32 in registers and keeps one
// accumulator per query of the tile.  out[q, n] is written with n
// contiguous across the warp.
//
// Bound on this card: 7 FP32 instructions per (q, n, j) (two subtracts, two
// maxes, two multiplies, an add: none fuses, see below), so the kernel is
// bound by the FP32 issue rate, 128 lanes an SM a clock; against it the
// 4 Q N output bytes are small at S = 16.  The design keeps that loop free
// of everything else.  A full tile (all SK_QT queries present, S a
// multiple of 16, 16-byte aligned int8 rows) runs sk_full: no predicate in
// the unrolled loops, the chunk's 16 weights in registers, the query tile
// read from shared memory as float4 (one broadcast load for 4 segments).
// A ragged tile (the last query tile of a Q that is no multiple of SK_QT,
// S % 16 != 0, or unaligned storage) runs sk_general, with predicates and
// byte loads; the choice is uniform per block.
//
// Arithmetic: per (q, n) the segments are summed in the order j = 0..S-1 as
// acc + (wseg_j * d) * d with every product and sum rounded on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), the order of the plain
// version kernels/ref.py:sketch_bound_scaled, so the two are bit-equal.
#include "common.cuh"

#include <stdint.h>

#define SK_THREADS 128
// queries a thread: 16 holds 72 registers and 28 resident warps per SM
// (ptxas and the occupancy calculator, chip_smoke.py's ptxas line), and
// ran faster than 8 or 32 on an NVIDIA H100 80GB HBM3 at 700 W
#define SK_QT 16
#define SK_CHUNK 16
#define SK_MAX_S 256

__device__ __forceinline__ float sk_cell(float a, float qv, float l, float h,
                                         float w) {
    const float d = fmaxf(fmaxf(__fsub_rn(qv, h), __fsub_rn(l, qv)), 0.f);
    return __fadd_rn(a, __fmul_rn(__fmul_rn(w, d), d));
}

__device__ __forceinline__ void sk_bytes(int word, float* f) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
        f[b] = (float)(int8_t)((unsigned)word >> (8 * b));
}

// A full tile: SK_QT queries, S % 16 == 0, 16-byte aligned rows.
__device__ __forceinline__ void sk_full(const float* __restrict__ q_sh,
                                        const float* __restrict__ w_sh,
                                        const int8_t* __restrict__ lr,
                                        const int8_t* __restrict__ hr,
                                        int S, float (&acc)[SK_QT]) {
    for (int j0 = 0; j0 < S; j0 += SK_CHUNK) {
        const int4 lv = *reinterpret_cast<const int4*>(lr + j0);
        const int4 hv = *reinterpret_cast<const int4*>(hr + j0);
        float lf[SK_CHUNK], hf[SK_CHUNK], wv[SK_CHUNK];
        sk_bytes(lv.x, lf);
        sk_bytes(lv.y, lf + 4);
        sk_bytes(lv.z, lf + 8);
        sk_bytes(lv.w, lf + 12);
        sk_bytes(hv.x, hf);
        sk_bytes(hv.y, hf + 4);
        sk_bytes(hv.z, hf + 8);
        sk_bytes(hv.w, hf + 12);
        const float4* w4 = reinterpret_cast<const float4*>(w_sh + j0);
#pragma unroll
        for (int j4 = 0; j4 < SK_CHUNK / 4; ++j4) {
            const float4 x = w4[j4];
            wv[4 * j4] = x.x;
            wv[4 * j4 + 1] = x.y;
            wv[4 * j4 + 2] = x.z;
            wv[4 * j4 + 3] = x.w;
        }
#pragma unroll
        for (int t = 0; t < SK_QT; ++t) {
            const float4* qr =
                reinterpret_cast<const float4*>(q_sh + t * S + j0);
            float a = acc[t];
#pragma unroll
            for (int j4 = 0; j4 < SK_CHUNK / 4; ++j4) {
                const float4 x = qr[j4];
                const int j = 4 * j4;
                a = sk_cell(a, x.x, lf[j], hf[j], wv[j]);
                a = sk_cell(a, x.y, lf[j + 1], hf[j + 1], wv[j + 1]);
                a = sk_cell(a, x.z, lf[j + 2], hf[j + 2], wv[j + 2]);
                a = sk_cell(a, x.w, lf[j + 3], hf[j + 3], wv[j + 3]);
            }
            acc[t] = a;
        }
    }
}

// Any tile: nq <= SK_QT queries, any S, byte loads unless aligned.
__device__ __forceinline__ void sk_general(const float* __restrict__ q_sh,
                                           const float* __restrict__ w_sh,
                                           const int8_t* __restrict__ lr,
                                           const int8_t* __restrict__ hr,
                                           int S, int nq, bool aligned,
                                           float (&acc)[SK_QT]) {
    for (int j0 = 0; j0 < S; j0 += SK_CHUNK) {
        const int nj = min(SK_CHUNK, S - j0);
        float lf[SK_CHUNK], hf[SK_CHUNK];
        if (aligned && nj == SK_CHUNK) {
            const int4 lv = *reinterpret_cast<const int4*>(lr + j0);
            const int4 hv = *reinterpret_cast<const int4*>(hr + j0);
            sk_bytes(lv.x, lf);
            sk_bytes(lv.y, lf + 4);
            sk_bytes(lv.z, lf + 8);
            sk_bytes(lv.w, lf + 12);
            sk_bytes(hv.x, hf);
            sk_bytes(hv.y, hf + 4);
            sk_bytes(hv.z, hf + 8);
            sk_bytes(hv.w, hf + 12);
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
                for (int j = 0; j < SK_CHUNK; ++j)
                    if (j < nj)
                        a = sk_cell(a, qr[j], lf[j], hf[j], w_sh[j0 + j]);
                acc[t] = a;
            }
        }
    }
}

// aligned: S % 16 == 0 and both int8 stores 16-byte aligned.
__global__ void __launch_bounds__(SK_THREADS)
sketch_bound_kernel(const float* __restrict__ qs,
                    const int8_t* __restrict__ lo,
                    const int8_t* __restrict__ hi,
                    const float* __restrict__ wseg,
                    float* __restrict__ out, int Q, int N, int S,
                    int aligned) {
    extern __shared__ float4 sh4[];
    float* w_sh = reinterpret_cast<float*>(sh4);    // (S,)
    float* q_sh = w_sh + S;                         // (SK_QT, S)
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
    float* oc = out + (size_t)q0 * N + n;
    if (aligned && nq == SK_QT) {
        sk_full(q_sh, w_sh, lr, hr, S, acc);
#pragma unroll
        for (int t = 0; t < SK_QT; ++t) oc[(size_t)t * N] = acc[t];
    } else {
        sk_general(q_sh, w_sh, lr, hr, S, nq, aligned != 0, acc);
#pragma unroll
        for (int t = 0; t < SK_QT; ++t)
            if (t < nq) oc[(size_t)t * N] = acc[t];
    }
}

// Shared-memory bytes a block needs for S segments, or -1 when S exceeds
// what the kernel takes.
extern "C" long long sketch_bound_smem_bytes(int S) {
    if (S < 1 || S > SK_MAX_S) return -1;
    return (long long)(SK_QT + 1) * S * 4;
}

// Resident warps per SM at S segments (CUDA's occupancy calculator at the
// launch's block size and shared memory), or minus a CUDA error.
extern "C" int sketch_bound_occupancy(int S) {
    const long long smem = sketch_bound_smem_bytes(S);
    if (smem < 0) return -(int)cudaErrorInvalidValue;
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, sketch_bound_kernel, SK_THREADS, (size_t)smem);
    return e == cudaSuccess ? n * (SK_THREADS / 32) : -(int)e;
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
