// K2: cross-block LB_ENHANCED^V, (Q, L) x (C, L) -> (Q, C).
//
// Replaces src/repro/kernels/lb_enhanced.py:lb_enhanced_pallas
// (_lb_enhanced_kernel, _lb_enhanced_kernel_live, body _block_rows).
// The cascade calls it once per tier over the whole store (the plain
// route chunks; search/cascade.py), so a launch is the (Q, N) matrix.
//
// Bands-only form (the cascade's `bands` tier, every search path):
// lb_bands_kernel.  The bands read only the first and last nb columns of
// each row, nb = min(L / 2, w, V) (4 on the paths).  A block covers
// LBB_TC candidates, one a thread, by LBB_TQ queries.  It stages those
// 2 nb columns of its candidates ([column][candidate], conflict-free)
// and of its queries in shared memory once, with coalesced loads (float4
// where the row ends are 16-byte aligned); each thread then keeps its
// candidate's 2 nb values in registers and walks the block's queries,
// whose values every lane reads at one shared address (a broadcast), and
// writes its column of the output coalesced along candidates.  nb = 1..8
// have their own instantiations (the loops unrolled, the values in
// registers); another nb runs the generic instantiation, which reads the
// band columns through the cache (rt_band_sum).
//
// Arithmetic: the bands are summed in the fixed order of
// core/lower_bounds.py (left bands 0..nb-1 from zero, then the right
// bands, then left + right), unfused.  A band takes the least |q - c| of
// its arm cells and squares it once: rounding is monotone, so
// min(fl(d1^2), fl(d2^2)) == fl(min(|d1|, |d2|)^2) for finite d, and the
// form is bit-equal to the plain version (which squares every cell).
//
// Bound on this card: 4 bytes written per pair against 4 nb^2 + 2 nb - 1
// FP32 operations per pair (71 at nb = 4): against the H100 SXM's
// published HBM rate and FP32 peak the two are of one order
// (chip_smoke.py computes the bound); the design reads every input byte
// once per block and keeps every store coalesced.
//
// Full form (the `enhanced_dense` tier, on no path): the first design, one
// thread per (query, candidate) pair, the bands by rt_band_sum and the
// Keogh bridge over [nb, L - nb) through shared-memory tiles of the
// queries and the envelopes, summed sequentially per pair (another order
// than the plain version's reduction, hence a tolerance there).
//
// live (optional, one byte per candidate): a dead candidate gives -inf
// down its column, and a block whose candidates are all dead writes its
// -inf outputs and skips the compute.
#include "common.cuh"

#include <stdint.h>

#define LBB_TC 128          // bands form: candidates per block, one a thread
#define LBB_TQ 32           // bands form: queries per block

#define LBX_TC 32
#define LBX_TQ 8
#define LBX_CH 64

// The bands of one pair from its staged values: v[k] is column k for
// k < NB and column L - 2 NB + k for k >= NB, of the query (qv) and the
// candidate (cv).
template <int NB>
__device__ __forceinline__ float lbb_bands(const float (&qv)[2 * NB],
                                           const float (&cv)[2 * NB]) {
    float left = 0.f, right = 0.f;
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
        float m = fabsf(__fsub_rn(qv[bi], cv[bi]));
#pragma unroll
        for (int j = 0; j < bi; ++j)
            m = fminf(m, fminf(fabsf(__fsub_rn(qv[j], cv[bi])),
                               fabsf(__fsub_rn(qv[bi], cv[j]))));
        left = __fadd_rn(left, __fmul_rn(m, m));
    }
#pragma unroll
    for (int bi = 0; bi < NB; ++bi) {
        const int i = 2 * NB - 1 - bi;          // column L - 1 - bi
        float m = fabsf(__fsub_rn(qv[i], cv[i]));
#pragma unroll
        for (int t = 1; t <= bi; ++t)
            m = fminf(m, fminf(fabsf(__fsub_rn(qv[i + t], cv[i])),
                               fabsf(__fsub_rn(qv[i], cv[i + t]))));
        right = __fadd_rn(right, __fmul_rn(m, m));
    }
    return __fadd_rn(left, right);
}

// Stage the 2 NB band columns of `rows` rows starting at `base` (row
// stride L) into dst[k * stride + r * rstride].
template <int NB>
__device__ __forceinline__ void lbb_stage(const float* __restrict__ base,
                                          int rows, int L, bool vec,
                                          float* dst, int stride,
                                          int rstride) {
    constexpr int W = 2 * NB;
    if constexpr (NB % 4 == 0) {
        if (vec) {
            constexpr int W4 = W / 4;
            for (int e = threadIdx.x; e < rows * W4; e += LBB_TC) {
                const int r = e / W4, k = 4 * (e % W4);
                const int col = k < NB ? k : L - W + k;
                const float4 x = *reinterpret_cast<const float4*>(
                    base + (size_t)r * L + col);
                dst[(k + 0) * stride + r * rstride] = x.x;
                dst[(k + 1) * stride + r * rstride] = x.y;
                dst[(k + 2) * stride + r * rstride] = x.z;
                dst[(k + 3) * stride + r * rstride] = x.w;
            }
            return;
        }
    }
    for (int e = threadIdx.x; e < rows * W; e += LBB_TC) {
        const int r = e / W, k = e % W;
        const int col = k < NB ? k : L - W + k;
        dst[k * stride + r * rstride] = base[(size_t)r * L + col];
    }
}

// NB > 0: the staged form for nb == NB; NB == 0: any nb (nb_any).
template <int NB>
__global__ void __launch_bounds__(LBB_TC)
lb_bands_kernel(const float* __restrict__ q, const float* __restrict__ c,
                const unsigned char* __restrict__ live,
                float* __restrict__ out, int Q, int C, int L, int nb_any,
                int vec) {
    constexpr int W = NB > 0 ? 2 * NB : 1;
    __shared__ float sc[W][LBB_TC + 1];         // [column][candidate]
    __shared__ float sq[LBB_TQ][W];             // [query][column]
    const int tx = threadIdx.x;
    const int c0 = blockIdx.x * LBB_TC, q0 = blockIdx.y * LBB_TQ;
    const int ci = c0 + tx;
    const int nq = min(LBB_TQ, Q - q0);
    const bool in = ci < C;
    bool alive = in;
    float* ocol = out + (size_t)q0 * C + ci;
    if (live != nullptr) {
        alive = in && live[ci] != 0;
        if (!__syncthreads_or(alive)) {          // all-dead candidate tile
            if (in)
                for (int t = 0; t < nq; ++t) ocol[(size_t)t * C] = -RT_INF;
            return;
        }
    }
    if constexpr (NB > 0) {
        lbb_stage<NB>(c + (size_t)c0 * L, min(LBB_TC, C - c0), L, vec != 0,
                      &sc[0][0], LBB_TC + 1, 1);
        lbb_stage<NB>(q + (size_t)q0 * L, nq, L, vec != 0, &sq[0][0], 1, W);
        __syncthreads();
        if (!in) return;
        float cv[W];
#pragma unroll
        for (int k = 0; k < W; ++k) cv[k] = sc[k][tx];
        for (int t = 0; t < nq; ++t) {
            float qv[W];
#pragma unroll
            for (int k = 0; k < W; ++k) qv[k] = sq[t][k];
            ocol[(size_t)t * C] = alive ? lbb_bands<NB>(qv, cv) : -RT_INF;
        }
    } else {
        if (!in) return;
        const float* cr = c + (size_t)ci * L;
        for (int t = 0; t < nq; ++t)
            ocol[(size_t)t * C] =
                alive ? rt_band_sum(q + (size_t)(q0 + t) * L, cr, L, nb_any)
                      : -RT_INF;
    }
}

__global__ void lb_enhanced_full_kernel(const float* __restrict__ q,
                                        const float* __restrict__ c,
                                        const float* __restrict__ u,
                                        const float* __restrict__ lo,
                                        const unsigned char* __restrict__ live,
                                        float* __restrict__ out, int Q,
                                        int C, int L, int nb) {
    __shared__ float sq[LBX_TQ][LBX_CH];
    __shared__ float su[LBX_TC][LBX_CH + 1];
    __shared__ float sl[LBX_TC][LBX_CH + 1];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int ci = blockIdx.x * LBX_TC + tx;
    const int qi = blockIdx.y * LBX_TQ + ty;
    const bool in = (ci < C) && (qi < Q);
    bool alive = true;
    if (live != nullptr) {
        alive = (ci < C) && live[ci] != 0;
        if (!__syncthreads_or(alive)) {          // all-dead candidate tile
            if (in) out[(size_t)qi * C + ci] = -RT_INF;
            return;
        }
    }

    const float bands =
        in ? rt_band_sum(q + (size_t)qi * L, c + (size_t)ci * L, L, nb) : 0.f;

    float bridge = 0.f;
    const int tid = ty * LBX_TC + tx;
    const int nthreads = LBX_TC * LBX_TQ;
    const int b1 = L - nb;
    for (int s0 = nb; s0 < b1; s0 += LBX_CH) {
        const int len = min(LBX_CH, b1 - s0);
        for (int e = tid; e < LBX_TQ * LBX_CH; e += nthreads) {
            const int r = e / LBX_CH, col = e % LBX_CH;
            const int gq = blockIdx.y * LBX_TQ + r;
            sq[r][col] = (gq < Q && col < len)
                ? q[(size_t)gq * L + s0 + col] : 0.f;
        }
        for (int e = tid; e < LBX_TC * LBX_CH; e += nthreads) {
            const int r = e / LBX_CH, col = e % LBX_CH;
            const int gc = blockIdx.x * LBX_TC + r;
            const bool ok = gc < C && col < len;
            su[r][col] = ok ? u[(size_t)gc * L + s0 + col] : 0.f;
            sl[r][col] = ok ? lo[(size_t)gc * L + s0 + col] : 0.f;
        }
        __syncthreads();
        for (int j = 0; j < len; ++j) {
            const float qv = sq[ty][j];
            const float over = fmaxf(qv - su[tx][j], 0.f);
            const float under = fmaxf(sl[tx][j] - qv, 0.f);
            bridge += over * over + under * under;
        }
        __syncthreads();
    }
    if (in) out[(size_t)qi * C + ci] = alive ? bands + bridge : -RT_INF;
}

template <int NB>
static void lbb_launch(dim3 grid, cudaStream_t s, const float* q,
                       const float* c, const unsigned char* live, float* out,
                       int Q, int C, int L, int nb, int vec) {
    lb_bands_kernel<NB><<<grid, LBB_TC, 0, s>>>(q, c, live, out, Q, C, L, nb,
                                                vec);
}

extern "C" int lb_enhanced_launch(const float* q, const float* c,
                                  const float* u, const float* lo,
                                  const unsigned char* live, float* out,
                                  int Q, int C, int L, int nb,
                                  int bands_only, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (!bands_only) {
        dim3 block(LBX_TC, LBX_TQ);
        dim3 grid((C + LBX_TC - 1) / LBX_TC, (Q + LBX_TQ - 1) / LBX_TQ);
        lb_enhanced_full_kernel<<<grid, block, 0, s>>>(q, c, u, lo, live, out,
                                                       Q, C, L, nb);
        return (int)cudaGetLastError();
    }
    dim3 grid((C + LBB_TC - 1) / LBB_TC, (Q + LBB_TQ - 1) / LBB_TQ);
    // float4 staging: every row end 16-byte aligned
    const int vec = L % 4 == 0
        && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(c))
            % 16) == 0;
    switch (nb) {
        case 1: lbb_launch<1>(grid, s, q, c, live, out, Q, C, L, nb, vec); break;
        case 2: lbb_launch<2>(grid, s, q, c, live, out, Q, C, L, nb, vec); break;
        case 3: lbb_launch<3>(grid, s, q, c, live, out, Q, C, L, nb, vec); break;
        case 4: lbb_launch<4>(grid, s, q, c, live, out, Q, C, L, nb, vec); break;
        case 5: lbb_launch<5>(grid, s, q, c, live, out, Q, C, L, nb, vec); break;
        case 6: lbb_launch<6>(grid, s, q, c, live, out, Q, C, L, nb, vec); break;
        case 7: lbb_launch<7>(grid, s, q, c, live, out, Q, C, L, nb, vec); break;
        case 8: lbb_launch<8>(grid, s, q, c, live, out, Q, C, L, nb, vec); break;
        default: lbb_launch<0>(grid, s, q, c, live, out, Q, C, L, nb, vec);
    }
    return (int)cudaGetLastError();
}
