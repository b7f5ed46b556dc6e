// K2: cross-block LB_ENHANCED^V, (Q, L) x (C, L) -> (Q, C).
//
// Replaces src/repro/kernels/lb_enhanced.py:lb_enhanced_pallas
// (_lb_enhanced_kernel, _lb_enhanced_kernel_live, body _block_rows).
// One thread per (query, candidate) output; a block covers LBX_TQ queries
// by LBX_TC candidates.  The elastic bands read only the first and last
// nb columns of each row and are summed in the fixed order of
// core/lower_bounds.py (rt_band_sum), so the bands-only form is bit-equal
// to the plain version.  The full form adds the Keogh bridge over [nb, L - nb): the
// query tile and the candidates' envelope tiles are staged through shared
// memory in LBX_CH-column chunks with coalesced loads, and each thread
// sums its pair's bridge sequentially (another order than the plain
// version's reduction, hence a tolerance there).
//
// Bounds on this card: the bands-only form (the cascade's main-path
// tier) writes 4 bytes per pair and does ~130 FP32 operations per pair
// at V = 4, so it is operation-bound; the full form reads 12 bytes per
// bridge column per candidate tile and does ~8 operations per (pair,
// column), which the shared-memory tiling turns into reuse across the
// LBX_TQ queries of a block.
//
// live (optional, one byte per candidate): a dead candidate gives -inf
// down its column, and a block whose candidates are all dead writes its
// -inf outputs and skips the compute.
#include "common.cuh"

#define LBX_TC 32
#define LBX_TQ 8
#define LBX_CH 64

template <bool BANDS_ONLY>
__global__ void lb_enhanced_kernel(const float* __restrict__ q,
                                   const float* __restrict__ c,
                                   const float* __restrict__ u,
                                   const float* __restrict__ lo,
                                   const unsigned char* __restrict__ live,
                                   float* __restrict__ out, int Q, int C,
                                   int L, int nb) {
    __shared__ float sq[BANDS_ONLY ? 1 : LBX_TQ][LBX_CH];
    __shared__ float su[BANDS_ONLY ? 1 : LBX_TC][LBX_CH + 1];
    __shared__ float sl[BANDS_ONLY ? 1 : LBX_TC][LBX_CH + 1];
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
    if constexpr (!BANDS_ONLY) {
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
    }
    if (in) out[(size_t)qi * C + ci] = alive ? bands + bridge : -RT_INF;
}

extern "C" int lb_enhanced_launch(const float* q, const float* c,
                                  const float* u, const float* lo,
                                  const unsigned char* live, float* out,
                                  int Q, int C, int L, int nb,
                                  int bands_only, void* stream) {
    dim3 block(LBX_TC, LBX_TQ);
    dim3 grid((C + LBX_TC - 1) / LBX_TC, (Q + LBX_TQ - 1) / LBX_TQ);
    cudaStream_t s = (cudaStream_t)stream;
    if (bands_only)
        lb_enhanced_kernel<true><<<grid, block, 0, s>>>(q, c, u, lo, live,
                                                        out, Q, C, L, nb);
    else
        lb_enhanced_kernel<false><<<grid, block, 0, s>>>(q, c, u, lo, live,
                                                         out, Q, C, L, nb);
    return (int)cudaGetLastError();
}
