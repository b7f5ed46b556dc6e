// The clamp-form Keogh sum over register tiles: the body shared by K8
// (csrc/lb_keogh.cu, every column of L) and K2's full form
// (csrc/lb_enhanced.cu, the bridge [nb, L - nb) of LB_ENHANCED^V).
//
// kg_tile sums, for a block's KG_TQ x KG_TC = 128 x 64 output tile,
//   acc[q, c] = sum_{i in [col0, col0 + ncol)} max(q_i - u_ci, 0)^2
//                                             + max(lo_ci - q_i, 0)^2
// into registers.  Bound on this card: FP32 operations, 5 per term (a
// max, a min, a subtract and one FFMA counted as two), the least a term
// needs; that peak counts an FFMA as two operations and three of a
// term's four instructions are not FMAs, so the attainable floor is the
// issue rate, 128 FP32 lanes an SM a clock at 4 instructions a term.
//
// - A term costs 4 FP32 instructions: d = q - min(max(q, lo), u), then
//   acc = fma(d, d, acc).  Where lo <= u, d^2 is the reference's
//   over^2 + under^2 bit for bit: q > u gives d = fl(q - u) = over;
//   q < lo gives d = fl(q - lo) = -fl(lo - q) (rounding is symmetric);
//   otherwise d = 0; infinite envelopes give 0 as the reference does.
// - Every input stays exact: a chunk that holds any envelope element with
//   !(lo <= u) (lo > u, or a NaN) runs the reference's arithmetic,
//   over * over + under * under with NaN-propagating clamps, rounded term
//   by term.  Each thread tests the envelope elements it staged and a
//   __syncthreads_or makes that one flag for the block, so valid
//   envelopes never pay for it.
// - A block of 256 threads computes the tile; a thread holds 8 queries
//   (rows 4 ty + i and 64 + 4 ty + i) x 4 candidates (4 tx + j) in
//   registers, so each column takes 4 float4 shared loads (two of
//   queries, one each of u and lo) for 32 terms.
// - The columns are walked in chunks of KG_KC = 32 from col0, staged
//   transposed ([column][row], padded so the staging writes hit 32 banks)
//   by 4-byte cp.async copies into two buffers: the next chunk's copies
//   run while this one is computed, one block barrier a chunk.  A thread
//   copies one column of every eighth row, its source a running pointer
//   (addresses kept as loop invariants cost a register each); interior
//   chunks copy without predicates.  Ragged Q, C and column ranges are
//   copies of 0 bytes (zero fill: d = 0); nothing is padded in device
//   memory.  4-byte copies take any col0.
// - A thread sums a chunk's 32 terms into a partial and adds the partial
//   to its running total, so at L = 17984 the sum keeps the plain
//   version's rtol 1e-5 (a running sum over all L terms would not).  The
//   order is other than the plain version's reduction: the two agree to
//   rtol 1e-5, atol 1e-6, not bit for bit.
#pragma once

#include "common.cuh"

#define KG_TQ 128                // queries a block
#define KG_TC 64                 // candidates a block
#define KG_KC 32                 // columns a chunk
#define KG_THREADS 256
#define KG_QS (KG_TQ + 4)        // row strides of the transposed chunks
#define KG_CS (KG_TC + 4)
#define KG_RS 8                  // row step of a thread's staged elements
// one buffer: q [KG_KC][KG_QS], u and lo [KG_KC][KG_CS]
#define KG_BUF (KG_KC * (KG_QS + 2 * KG_CS))
#define KG_SMEM (2 * KG_BUF * 4)

// 4 bytes global -> shared, asynchronously; !ok copies 0 bytes and fills
// the word with zeros
__device__ __forceinline__ void kg_copy(float* dst, const float* src,
                                        bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 4 : 0));
}

// the reference's max(x, 0), NaN kept (torch.clamp(min=0))
__device__ __forceinline__ float kg_pos(float x) { return x < 0.f ? 0.f : x; }

// The Keogh sums of columns [col0, col0 + ncol) (rows of length L) of the
// block's tile, queries q0 = blockIdx.y * KG_TQ.. and candidates
// c0 = blockIdx.x * KG_TC.., handed to epi(acc, q0, c0, ty, tx): acc[i][j]
// is query q0 + 64 (i / 4) + 4 ty + i % 4 against candidate c0 + 4 tx + j,
// with ty = tid / 16, tx = tid % 16.  sm holds KG_SMEM bytes; every
// thread of the block calls it, and no copy is in flight when epi runs.
template <class Epi>
__device__ __forceinline__ void kg_tile(const float* __restrict__ q,
                                        const float* __restrict__ u,
                                        const float* __restrict__ lo,
                                        float* sm, int Q, int C, int L,
                                        int col0, int ncol, Epi&& epi) {
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int ty = tid >> 4, tx = tid & 15;
    const int q0 = blockIdx.y * KG_TQ;
    const int c0 = blockIdx.x * KG_TC;
    // staging: a warp copies 8 consecutive columns of 4 rows at a time;
    // this thread copies column kk of rows rb, rb + 8, ... of each array
    const int kk = (warp & 3) * 8 + (lane & 7);
    const int rb = (warp >> 2) * 4 + (lane >> 3);
    const size_t step = (size_t)KG_RS * L;
    auto stage = [&](int k0, int buf) {
        float* q_sh = sm + buf * KG_BUF + kk * KG_QS + rb;
        float* u_sh = sm + buf * KG_BUF + KG_KC * KG_QS + kk * KG_CS + rb;
        float* l_sh = u_sh + KG_KC * KG_CS;
        const float* qs = q + (size_t)(q0 + rb) * L + col0 + k0 + kk;
        const size_t off0 = (size_t)(c0 + rb) * L + col0 + k0 + kk;
        if (q0 + KG_TQ <= Q && c0 + KG_TC <= C && k0 + KG_KC <= ncol) {
            // an interior chunk: no predicates
            const float* us = u + off0;
            const float* ls = lo + off0;
#pragma unroll 4
            for (int i = 0; i < KG_TQ / KG_RS; ++i, qs += step)
                kg_copy(q_sh + KG_RS * i, qs, true);
#pragma unroll 4
            for (int i = 0; i < KG_TC / KG_RS; ++i, us += step, ls += step) {
                kg_copy(u_sh + KG_RS * i, us, true);
                kg_copy(l_sh + KG_RS * i, ls, true);
            }
        } else {
            const bool kin = k0 + kk < ncol;
#pragma unroll 4
            for (int i = 0; i < KG_TQ / KG_RS; ++i, qs += step) {
                const bool ok = kin && q0 + rb + KG_RS * i < Q;
                kg_copy(q_sh + KG_RS * i, ok ? qs : q, ok);
            }
#pragma unroll 4
            for (int i = 0; i < KG_TC / KG_RS; ++i) {
                const bool ok = kin && c0 + rb + KG_RS * i < C;
                const size_t off = ok ? off0 + i * step : 0;
                kg_copy(u_sh + KG_RS * i, u + off, ok);
                kg_copy(l_sh + KG_RS * i, lo + off, ok);
            }
        }
        asm volatile("cp.async.commit_group;\n" ::);
    };
    // !(lo <= u) among the envelope elements this thread staged
    auto invalid = [&](int buf) {
        const float* u_sh =
            sm + buf * KG_BUF + KG_KC * KG_QS + kk * KG_CS + rb;
        const float* l_sh = u_sh + KG_KC * KG_CS;
        bool bad = false;
#pragma unroll
        for (int i = 0; i < KG_TC / KG_RS; ++i)
            bad |= !(l_sh[KG_RS * i] <= u_sh[KG_RS * i]);
        return bad;
    };

    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    const int nk = (ncol + KG_KC - 1) / KG_KC;
    if (nk > 0) stage(0, 0);
    for (int kc = 0; kc < nk; ++kc) {
        const int buf = kc & 1;
        asm volatile("cp.async.wait_group 0;\n" ::);    // my copies landed
        // every copy of this chunk is visible, the other buffer is read
        const bool bad = __syncthreads_or(invalid(buf));
        if (kc + 1 < nk) stage((kc + 1) * KG_KC, buf ^ 1);
        const float* q_sh = sm + buf * KG_BUF + 4 * ty;
        const float* u_sh = sm + buf * KG_BUF + KG_KC * KG_QS + 4 * tx;
        const float* l_sh = u_sh + KG_KC * KG_CS;
        float part[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
        if (!bad) {
#pragma unroll 8
            for (int k = 0; k < KG_KC; ++k) {
                const float4 qa =
                    *reinterpret_cast<const float4*>(q_sh + k * KG_QS);
                const float4 qb =
                    *reinterpret_cast<const float4*>(q_sh + k * KG_QS + 64);
                const float4 uu =
                    *reinterpret_cast<const float4*>(u_sh + k * KG_CS);
                const float4 ll =
                    *reinterpret_cast<const float4*>(l_sh + k * KG_CS);
                const float qv[8] = {qa.x, qa.y, qa.z, qa.w,
                                     qb.x, qb.y, qb.z, qb.w};
                const float uv[4] = {uu.x, uu.y, uu.z, uu.w};
                const float lv[4] = {ll.x, ll.y, ll.z, ll.w};
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float d =
                            qv[i] - fminf(fmaxf(qv[i], lv[j]), uv[j]);
                        part[i][j] = fmaf(d, d, part[i][j]);
                    }
            }
        } else {
            // the reference's arithmetic, term by term
#pragma unroll 1
            for (int k = 0; k < KG_KC; ++k) {
                float qv[8], uv[4], lv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    qv[i] = q_sh[k * KG_QS + i];
                    qv[4 + i] = q_sh[k * KG_QS + 64 + i];
                    uv[i] = u_sh[k * KG_CS + i];
                    lv[i] = l_sh[k * KG_CS + i];
                }
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float over = kg_pos(__fsub_rn(qv[i], uv[j]));
                        const float under = kg_pos(__fsub_rn(lv[j], qv[i]));
                        part[i][j] = __fadd_rn(
                            part[i][j], __fadd_rn(__fmul_rn(over, over),
                                                  __fmul_rn(under, under)));
                    }
            }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    }
    epi(acc, q0, c0, ty, tx);
}
