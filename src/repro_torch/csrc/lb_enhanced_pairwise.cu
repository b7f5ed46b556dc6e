// K3: packed pairwise LB_ENHANCED^V, row p of (P, L) queries against row p
// of (P, L) candidates and their envelopes -> (P,).
//
// Replaces src/repro/kernels/lb_enhanced_pairwise.py:
// lb_enhanced_pairwise_pallas (_lb_enhanced_pairwise_kernel, _live, body
// _bands_and_bridge).  One warp per pair, LBP_WARPS pairs per block.  The
// Keogh bridge over [nb, L - nb) is read by the warp's lanes at
// neighbouring addresses (coalesced along L) and summed with a warp
// shuffle; lane 0 takes the elastic bands from the row's two ends in the
// fixed order of core/lower_bounds.py (rt_band_sum).  The bridge's order
// differs from the plain version's reduction, hence a tolerance there.
//
// Bound on this card: each pair reads its query and envelope rows once
// (about 12 L bytes, 16 L with the candidate row the Pallas kernel also
// moved) for ~8 L FP32 operations, so the kernel is memory-bound; the
// design keeps every load coalesced and every pair in one pass.
//
// live (optional, one byte per pair): a dead slot gives -inf and its warp
// skips the compute, so a block whose slots are all dead does no work.
#include "common.cuh"

#define LBP_WARPS 8

template <bool BANDS_ONLY>
__global__ void lb_enhanced_pairwise_kernel(
        const float* __restrict__ q, const float* __restrict__ c,
        const float* __restrict__ u, const float* __restrict__ lo,
        const unsigned char* __restrict__ live, float* __restrict__ out,
        int P, int L, int nb) {
    const int lane = threadIdx.x & 31;
    const long long p = (long long)blockIdx.x * LBP_WARPS + (threadIdx.x >> 5);
    if (p >= P) return;
    if (live != nullptr && live[p] == 0) {
        if (lane == 0) out[p] = -RT_INF;
        return;
    }
    const float* qr = q + p * L;
    float bridge = 0.f;
    if constexpr (!BANDS_ONLY) {
        const float* ur = u + p * L;
        const float* lr = lo + p * L;
        for (int i = nb + lane; i < L - nb; i += 32) {
            const float qv = qr[i];
            const float over = fmaxf(qv - ur[i], 0.f);
            const float under = fmaxf(lr[i] - qv, 0.f);
            bridge += over * over + under * under;
        }
        for (int o = 16; o > 0; o >>= 1)
            bridge += __shfl_xor_sync(0xffffffffu, bridge, o);
    }
    if (lane == 0) out[p] = rt_band_sum(qr, c + p * L, L, nb) + bridge;
}

extern "C" int lb_enhanced_pairwise_launch(
        const float* q, const float* c, const float* u, const float* lo,
        const unsigned char* live, float* out, int P, int L, int nb,
        int bands_only, void* stream) {
    const int blocks = (P + LBP_WARPS - 1) / LBP_WARPS;
    cudaStream_t s = (cudaStream_t)stream;
    if (bands_only)
        lb_enhanced_pairwise_kernel<true><<<blocks, 32 * LBP_WARPS, 0, s>>>(
            q, c, u, lo, live, out, P, L, nb);
    else
        lb_enhanced_pairwise_kernel<false><<<blocks, 32 * LBP_WARPS, 0, s>>>(
            q, c, u, lo, live, out, P, L, nb);
    return (int)cudaGetLastError();
}
