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
// Full form (the `enhanced_dense` tier: CascadeConfig(staged=False), whose
// dense_plan scores every pair with the whole bound):
// lb_enhanced_full_kernel.
// LB_ENHANCED^V is the bands plus exactly K8's sum over the bridge
// [nb, L - nb), so a block runs K8's body, kg_tile of csrc/lb_keogh.cuh,
// over those columns: a 128 x 64 output tile, 8 x 4 sums a thread in
// registers, 32-column chunks by cp.async into two buffers, a partial a
// chunk, the !(lo <= u) vote (that header gives the bound and the design).
// Then the block stages its tile's bridge sums ([query][candidate]) and
// the 2 nb band columns of its queries and candidates ([column][row]) in
// the freed buffers, and each thread walks one candidate down the tile's
// queries (its band values in registers, the query's a broadcast), sums
// the bands by lbb_bands<NB> (nb = 1..8; another nb by rt_band_sum from
// device memory), bit-equal to the plain bands, and writes one unfused
// __fadd_rn(bands, bridge), coalesced along candidates: the order of
// core/lower_bounds.py.  At nb = 0 the bands are 0 and the output is K8's
// sum bit for bit; at nb = L / 2 with L even the bridge is empty and the
// output is the bands form's.  The bridge's sum runs in another order
// than the plain version's reduction: the two agree to rtol 1e-5,
// atol 1e-6.
//
// live (optional, one byte per candidate): a dead candidate gives -inf
// down its column, and a block whose candidates are all dead (padded
// candidates count as dead) writes its -inf outputs and skips its copies
// and compute.
#include "lb_keogh.cuh"

#include <stdint.h>

#include <type_traits>

#define LBB_TC 128          // bands form: candidates per block, one a thread
#define LBB_TQ 32           // bands form: queries per block

// full form: the epilogue's bridge sums, [query][candidate] from float 0,
// then the band columns, [column][query] and [column][candidate]
#define LBF_OS (KG_TC + 4)
#define LBF_BANDS (KG_TQ * LBF_OS)
static_assert(LBF_BANDS + 16 * (KG_QS + KG_CS) <= 2 * KG_BUF,
              "the full form's epilogue must fit the chunk buffers");

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
// stride L) into dst[k * stride + r * rstride], NT threads a block.
template <int NB, int NT = LBB_TC>
__device__ __forceinline__ void lbb_stage(const float* __restrict__ base,
                                          int rows, int L, bool vec,
                                          float* dst, int stride,
                                          int rstride) {
    constexpr int W = 2 * NB;
    if constexpr (NB % 4 == 0) {
        if (vec) {
            constexpr int W4 = W / 4;
            for (int e = threadIdx.x; e < rows * W4; e += NT) {
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
    for (int e = threadIdx.x; e < rows * W; e += NT) {
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

// NB > 0: the bands staged for nb == NB; NB == 0: any nb (nb_any), the
// bands read from device memory.
template <int NB>
__global__ void __launch_bounds__(KG_THREADS, 2)
lb_enhanced_full_kernel(const float* __restrict__ q,
                        const float* __restrict__ c,
                        const float* __restrict__ u,
                        const float* __restrict__ lo,
                        const unsigned char* __restrict__ live,
                        float* __restrict__ out, int Q, int C, int L,
                        int nb_any, int vec) {
    extern __shared__ float4 lbf_sm4[];
    float* sm = reinterpret_cast<float*>(lbf_sm4);
    const int tid = threadIdx.x;
    const int q0 = blockIdx.y * KG_TQ, c0 = blockIdx.x * KG_TC;
    const int nq = min(KG_TQ, Q - q0), ncand = min(KG_TC, C - c0);
    const int nb = NB > 0 ? NB : nb_any;
    // the epilogue's outputs: candidate cj, queries r0, r0 + 4, ...
    constexpr int RSTEP = KG_THREADS / KG_TC;
    const int cj = tid % KG_TC, r0 = tid / KG_TC;
    const bool cin = cj < ncand;
    bool alive = cin;
    float* ocol = out + (size_t)q0 * C + c0 + cj;
    if (live != nullptr) {
        alive = cin && live[c0 + cj] != 0;
        if (!__syncthreads_or(alive)) {          // all-dead candidate tile
            if (cin)
                for (int r = r0; r < nq; r += RSTEP)
                    ocol[(size_t)r * C] = -RT_INF;
            return;
        }
    }
    kg_tile(q, u, lo, sm, Q, C, L, nb, L - 2 * nb,
            [&](const float (&acc)[8][4], int, int, int ty, int tx) {
        __syncthreads();                         // the buffers are free
#pragma unroll
        for (int i = 0; i < 8; ++i)
            *reinterpret_cast<float4*>(
                sm + (64 * (i / 4) + 4 * ty + i % 4) * LBF_OS + 4 * tx) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    });
    constexpr int W = NB > 0 ? 2 * NB : 1;
    float* bq = sm + LBF_BANDS;                  // [column][query]
    float* bc = bq + W * KG_QS;                  // [column][candidate]
    if constexpr (NB > 0) {
        lbb_stage<NB, KG_THREADS>(q + (size_t)q0 * L, nq, L, vec != 0, bq,
                                  KG_QS, 1);
        lbb_stage<NB, KG_THREADS>(c + (size_t)c0 * L, ncand, L, vec != 0,
                                  bc, KG_CS, 1);
    }
    __syncthreads();
    if (!cin) return;
    if constexpr (NB > 0) {
        float cv[W];
#pragma unroll
        for (int k = 0; k < W; ++k) cv[k] = bc[k * KG_CS + cj];
#pragma unroll 1
        for (int r = r0; r < nq; r += RSTEP) {
            float qv[W];
#pragma unroll
            for (int k = 0; k < W; ++k) qv[k] = bq[k * KG_QS + r];
            ocol[(size_t)r * C] =
                alive ? __fadd_rn(lbb_bands<NB>(qv, cv), sm[r * LBF_OS + cj])
                      : -RT_INF;
        }
    } else {
        const float* cr = c + (size_t)(c0 + cj) * L;
#pragma unroll 1
        for (int r = r0; r < nq; r += RSTEP)
            ocol[(size_t)r * C] =
                alive ? __fadd_rn(rt_band_sum(q + (size_t)(q0 + r) * L, cr,
                                              L, nb),
                                  sm[r * LBF_OS + cj])
                      : -RT_INF;
    }
}

// f(std::integral_constant<int, NB>()) for NB = nb in 1..8 (the unrolled
// instantiations), NB = 0 (the generic one) for any other nb
template <class F>
static int lb_by_nb(int nb, F&& f) {
    switch (nb) {
        case 1: return f(std::integral_constant<int, 1>());
        case 2: return f(std::integral_constant<int, 2>());
        case 3: return f(std::integral_constant<int, 3>());
        case 4: return f(std::integral_constant<int, 4>());
        case 5: return f(std::integral_constant<int, 5>());
        case 6: return f(std::integral_constant<int, 6>());
        case 7: return f(std::integral_constant<int, 7>());
        case 8: return f(std::integral_constant<int, 8>());
        default: return f(std::integral_constant<int, 0>());
    }
}

extern "C" int lb_enhanced_launch(const float* q, const float* c,
                                  const float* u, const float* lo,
                                  const unsigned char* live, float* out,
                                  int Q, int C, int L, int nb,
                                  int bands_only, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    // float4 staging of the band columns: every row end 16-byte aligned
    const int vec = L % 4 == 0
        && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(c))
            % 16) == 0;
    if (!bands_only) {
        dim3 grid((C + KG_TC - 1) / KG_TC, (Q + KG_TQ - 1) / KG_TQ);
        return lb_by_nb(nb, [&](auto k) {
            constexpr int NB = decltype(k)::value;
            cudaError_t e = cudaFuncSetAttribute(
                lb_enhanced_full_kernel<NB>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, KG_SMEM);
            if (e != cudaSuccess) return (int)e;
            lb_enhanced_full_kernel<NB><<<grid, KG_THREADS, KG_SMEM, s>>>(
                q, c, u, lo, live, out, Q, C, L, nb, vec);
            return (int)cudaGetLastError();
        });
    }
    dim3 grid((C + LBB_TC - 1) / LBB_TC, (Q + LBB_TQ - 1) / LBB_TQ);
    return lb_by_nb(nb, [&](auto k) {
        constexpr int NB = decltype(k)::value;
        lb_bands_kernel<NB><<<grid, LBB_TC, 0, s>>>(q, c, live, out, Q, C, L,
                                                    nb, vec);
        return (int)cudaGetLastError();
    });
}
