// K9: fused attention forward with online softmax (GQA, causal, sliding
// window, score soft-cap).  q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D)
// -> o (B, Sq, Hq, D) in q's type.  Positions are implicit: query row i
// attends key rows <= i (causal) and > i - window.  Three forms
// (kernels/flash_attention.py picks): for D <= 256 by the input type,
//
//   bfloat16  flash_fwd_wgmma: tensor cores (wgmma), K/V tiles by TMA
//             (below, after the f32 form);
//   float32   flash_fwd_kernel: CUDA cores in f32 (this part), which the
//             f32 sweep's 1e-4 tolerance needs (neither bf16 nor TF32
//             products meet it);
//
// and for D > 256, either type, in f32 (at the end of the file):
// flash_wide_kernel up to D = 1024, one pass over a thread-block cluster
// split along D; past it flash_wide_stats + flash_wide_out, two passes
// whose shared memory is fixed in D.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_fwd_kernel).  Bound on this card: operations -- 4 D per
// unmasked (query head, key) pair, against q, k, v and o read or written
// once (at gemma2-2b's B = 2, S = 8192, Hq = 8, Hkv = 4, D = 256 a global
// layer is ~0.55 TFLOP against ~0.2 GB).  Both forms fold the g query
// heads of a kv head into a block's rows as the Pallas kernel folds them
// into its tile rows (row r = query q0 + r / g, head hk g + r % g), so a
// K/V tile is read once for all g heads; key tiles wholly outside the
// causal wedge or the window are never loaded; ragged Sq and Skv are
// bounds checks (f32) or the TMA's zero fill (bf16); nothing is padded
// in device memory.
//
// Semantics of the reference kept: cap * tanh(s / cap) before the mask;
// masked scores take the finite -2.3819763e38 (so a row's first
// all-masked tile is wiped by the first real score's alpha = 0, as in
// the reference); l is floored at 1e-30 in the final divide.  The f32
// form scales q by D**-0.5 in f32 before the product, as the reference.
// The D-sum and the key-sum run in another order than the plain
// version's, so the two agree to a tolerance, not bit for bit.
//
// The f32 form, simple first: one block of 256 threads per (batch x kv
// head, query tile of 64 folded rows); the scaled query rows stay in
// shared memory in f32; the block walks key tiles of FA_TK rows (staged
// in shared memory in f32) with the online-softmax state (m, l) per row
// in shared memory and acc in registers.
#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "wgmma.cuh"

#define FA_R 64            // folded (query, head) rows per block
#define FA_TK 32           // key rows per tile
#define FA_THREADS 256
#define FA_NEG (-2.3819763e38f)

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ void fa_store(float* p, float x) { *p = x; }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);           // round to nearest even
}

template <int DMAX>
constexpr int fa_smem_floats() {
    return FA_R * (DMAX + 1) + FA_TK * (DMAX + 1) + FA_TK * DMAX
           + FA_R * (FA_TK + 1) + 3 * FA_R;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq,
                 int Skv, int Hq, int Hkv, int D, int g, int tq, int causal,
                 int window, float cap, float scale) {
    constexpr int QS = DMAX + 1;        // padded stride of q and k rows
    constexpr int PS = FA_TK + 1;
    constexpr int ND = DMAX / 32;       // head-dim columns per thread
    extern __shared__ float smem[];
    float* q_sh = smem;                 // [FA_R][QS]
    float* k_sh = q_sh + FA_R * QS;     // [FA_TK][QS]
    float* v_sh = k_sh + FA_TK * QS;    // [FA_TK][DMAX]
    float* p_sh = v_sh + FA_TK * DMAX;  // [FA_R][PS] scores, then probs
    float* m_sh = p_sh + FA_R * PS;     // [FA_R] running max
    float* l_sh = m_sh + FA_R;          // [FA_R] running normaliser
    float* a_sh = l_sh + FA_R;          // [FA_R] this tile's rescale

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
    const int q0 = blockIdx.y * tq;
    const int nq = min(tq, Sq - q0);    // valid queries of the tile
    const int rows = tq * g;

    // the scaled query rows, zero past the valid ones
    for (int e = tid; e < FA_R * D; e += FA_THREADS) {
        const int r = e / D, d = e % D;
        float x = 0.f;
        if (r < rows && r / g < nq) {
            const int qi = q0 + r / g, h = hk * g + r % g;
            x = fa_load(q + (((size_t)b * Sq + qi) * Hq + h) * D + d) * scale;
        }
        q_sh[r * QS + d] = x;
    }
    for (int r = tid; r < FA_R; r += FA_THREADS) {
        m_sh[r] = FA_NEG;
        l_sh[r] = 0.f;
    }
    float acc[8][ND];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;

    // key tiles that hold an unmasked (valid query, key) pair
    int kbeg = 0, kend = Skv;
    if (causal) kend = min(Skv, q0 + nq);
    if (window > 0) kbeg = max(0, q0 - window + 1);
    kbeg = (kbeg / FA_TK) * FA_TK;

    const int tr = tid >> 4, tc = tid & 15;     // score micro-tile
    for (int k0 = kbeg; k0 < kend; k0 += FA_TK) {
        __syncthreads();                // the last tile's k, v, p are read
        for (int e = tid; e < FA_TK * D; e += FA_THREADS) {
            const int j = e / D, d = e % D;
            const int kj = k0 + j;
            float kx = 0.f, vx = 0.f;
            if (kj < Skv) {
                const size_t off = (((size_t)b * Skv + kj) * Hkv + hk) * D + d;
                kx = fa_load(k + off);
                vx = fa_load(v + off);
            }
            k_sh[j * QS + d] = kx;
            v_sh[j * DMAX + d] = vx;
        }
        for (int e = tid; e < FA_TK * (DMAX - D); e += FA_THREADS)
            v_sh[(e / (DMAX - D)) * DMAX + D + e % (DMAX - D)] = 0.f;
        __syncthreads();

        // scores: rows tr*4 .. tr*4+3, key columns tc and tc + 16
        float s[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
            const float k0v = k_sh[tc * QS + d];
            const float k1v = k_sh[(tc + 16) * QS + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float qv = q_sh[(tr * 4 + i) * QS + d];
                s[i][0] += qv * k0v;
                s[i][1] += qv * k1v;
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = tr * 4 + i;
            const int qi = q0 + r / g;
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
                const int c = tc + 16 * jj;
                const int kj = k0 + c;
                float x = s[i][jj];
                if (cap > 0.f) x = cap * tanhf(x / cap);
                const int dp = qi - kj;
                bool ok = kj < Skv;
                if (causal) ok = ok && dp >= 0;
                if (window > 0) ok = ok && dp < window;
                p_sh[r * PS + c] = ok ? x : FA_NEG;
            }
        }
        __syncthreads();

        // online softmax: warp w takes rows 8w .. 8w+7, lane = key column
        for (int i = 0; i < 8; ++i) {
            const int r = warp * 8 + i;
            const float x = p_sh[r * PS + lane];
            float mx = x;
            for (int off = 16; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_prev = m_sh[r];
            const float m_new = fmaxf(m_prev, mx);
            const float p = expf(x - m_new);
            float sum = p;
            for (int off = 16; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            p_sh[r * PS + lane] = p;
            __syncwarp();
            if (lane == 0) {
                const float alpha = expf(m_prev - m_new);
                l_sh[r] = l_sh[r] * alpha + sum;
                m_sh[r] = m_new;
                a_sh[r] = alpha;
            }
        }
        __syncthreads();

        // acc = acc * alpha + p v: rows warp + 8 i, columns lane + 32 j
        // (the tile's products are added into the rescaled acc one key at
        // a time)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float alpha = a_sh[warp + 8 * i];
#pragma unroll
            for (int j = 0; j < ND; ++j) acc[i][j] *= alpha;
        }
        for (int c = 0; c < FA_TK; ++c) {
            float vv[ND];
#pragma unroll
            for (int j = 0; j < ND; ++j)
                vv[j] = v_sh[c * DMAX + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float p = p_sh[(warp + 8 * i) * PS + c];
#pragma unroll
                for (int j = 0; j < ND; ++j) acc[i][j] += p * vv[j];
            }
        }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = warp + 8 * i;
        if (r >= rows || r / g >= nq) continue;
        const int qi = q0 + r / g, h = hk * g + r % g;
        const float den = fmaxf(l_sh[r], 1e-30f);
        T* orow = o + (((size_t)b * Sq + qi) * Hq + h) * D;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
            const int d = lane + 32 * j;
            if (d < D) fa_store(orow + d, acc[i][j] / den);
        }
    }
}

template <typename T, int DMAX>
static int flash_launch_t(const void* q, const void* k, const void* v,
                          void* o, int B, int Sq, int Skv, int Hq, int Hkv,
                          int D, int causal, int window, float cap,
                          float scale, cudaStream_t stream) {
    const int g = Hq / Hkv;
    const int tq = FA_R / g;
    const int smem = fa_smem_floats<DMAX>() * (int)sizeof(float);
    auto kern = flash_fwd_kernel<T, DMAX>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(B * Hkv, (Sq + tq - 1) / tq);
    kern<<<grid, FA_THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Skv, Hq, Hkv, D,
        g, tq, causal, window, cap, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int flash_launch_d(const void* q, const void* k, const void* v,
                          void* o, int B, int Sq, int Skv, int Hq, int Hkv,
                          int D, int causal, int window, float cap,
                          float scale, cudaStream_t s) {
    if (D <= 64)
        return flash_launch_t<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                     causal, window, cap, scale, s);
    if (D <= 128)
        return flash_launch_t<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                      causal, window, cap, scale, s);
    return flash_launch_t<T, 256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                  causal, window, cap, scale, s);
}

// window <= 0: none; cap <= 0: none.  The wrapper
// (kernels/flash_attention.py) has checked D <= 256, Hq % Hkv == 0 and
// Hq / Hkv <= FA_R.
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int Sq, int Skv, int Hq, int Hkv,
                                          int D, int causal, int window,
                                          float cap, float scale,
                                          void* stream) {
    return flash_launch_d<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal,
                                 window, cap, scale, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// The bf16 form: tensor cores.
//
// One block of 384 threads per (batch x kv head, query tile of 128 folded
// rows): two consumer warpgroups of 64 rows each and a producer warpgroup that
// gives its registers to them (setmaxnreg: 24 against 240, so the D = 256
// accumulators do not spill). The producer's first lane loads the block's Q
// tile once, then the K and V tiles of 64 keys, by TMA (4-D tensor maps over
// (D, heads, S, B), 128-byte swizzle, zero fill past Sq, Skv and D) into a
// two-stage ring in shared memory; a stage completes on its "full" mbarrier
// (transaction bytes) and is handed back on its "empty" mbarrier, on which the
// eight consumer warps arrive. A consumer warpgroup computes S = Q K^T on
// wgmma (m64n64k16, Q and K from shared memory, f32 accumulators in
// registers), scales S by D**-0.5 in f32 after the product (exact at D = 256:
// 1/16), applies the cap and, on tiles that straddle a mask boundary only, the
// masks, and runs the online softmax in registers: a row's 64 scores sit on
// the four threads of a quad, so the row maximum takes two shuffles and the
// row sums stay per thread until the end. P goes to bf16 as the A operand of
// O += P V (wgmma m64nDPk16, P from registers in the accumulator's own layout,
// V from shared memory MN-major). Shared memory at D = 256: 64 KB of Q and 2 x
// (32 + 32) KB of K/V. A head dim below 64, 128 or 256 is padded to it in
// shared memory by the TMA's zero fill (D = 96 computes 128 columns), never in
// device memory. Query tiles run latest first, since under the causal mask
// they hold the most key tiles.
//
// Precision.  P is rounded to bf16 for the PV product, where the reference
// keeps it in f32; l sums the f32 P.  That is a bf16 rounding of weights
// in [0, 1], within K9's bf16 tolerance (rtol 1e-2, atol 1e-2):
// tests/test_torch_lm_kernels.py emulates this arithmetic and holds it to
// the Pallas kernel and the plain version, and chip_smoke.py holds the
// kernel to the plain version at the scoring prefill's layers.  exp is
// ex2.approx (relative error ~2^-22, PTX ISA).  The cap's tanh(y) is
// 1 - 2 / (1 + 2^(2 y log2 e)) on ex2.approx and rcp.approx: absolute
// error ~1e-7 in tanh, ~5e-6 in a score capped at 50, where
// tanh.approx.f32 (maximum relative error ~2^-11, PTX ISA) would err by
// up to ~0.02.
namespace fa {

constexpr int BM = 128;                 // folded rows per block
constexpr int BN = 64;                  // keys per tile
// two consumer warpgroups, then a producer warpgroup whose first warp
// issues the copies; setmaxnreg moves registers from the producer (24) to
// the consumers (240)
constexpr int THREADS = 384;
constexpr float LOG2E = 1.4426950408889634f;

// shared-memory layout (bytes from a 1024-aligned base): Q as DP / 64
// column blocks of [BM][64] bf16, then two K stages and two V stages, each
// DP / 64 column blocks of [BN][64] (128-byte rows, 128-byte swizzle), then
// the mbarriers full[2], empty[2] and q
template <int DP>
struct Layout {
    static constexpr int TILE = BN * DP * 2;
    static constexpr int Q = 0;
    static constexpr int K = Q + BM * DP * 2;
    static constexpr int V = K + 2 * TILE;
    static constexpr int BAR = V + 2 * TILE;
    static constexpr int BYTES = BAR + 64 + 1024;   // + room to align the base
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
                 : "memory");
}
// waits until the phase of parity ``parity`` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}
__device__ __forceinline__ float rcp(float x) {
    float y;
    asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
}
template <int DP>
__device__ __forceinline__ void pv_product(float (&acc)[DP / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
    if constexpr (DP == 64)
        wgmma_m64n64k16_rs(acc, a, db);
    else if constexpr (DP == 128)
        wgmma_m64n128k16_rs(acc, a, db);
    else
        wgmma_m64n256k16_rs(acc, a, db);
}

}  // namespace fa

template <int DP>
__global__ void __launch_bounds__(fa::THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, int Sq, int Skv, int Hq,
                int Hkv, int D, int g, int tq, int causal, int window,
                float cap, float scale) {
    using namespace fa;
    using Lay = Layout<DP>;
    extern __shared__ uint8_t fa_smem[];
    const uint32_t base =
        ((uint32_t)__cvta_generic_to_shared(fa_smem) + 1023u) & ~1023u;
    const uint32_t sq = base + Lay::Q, sk = base + Lay::K,
                   sv = base + Lay::V;
    const uint32_t full_bar = base + Lay::BAR;      // + 8 s
    const uint32_t empty_bar = full_bar + 16;       // + 8 s
    const uint32_t q_bar = full_bar + 32;

    const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * tq;
    const int nq = min(tq, Sq - q0);    // valid queries of the tile
    const int rows = tq * g;
    // key tiles that hold an unmasked (valid query, key) pair
    int kbeg = 0, kend = Skv;
    if (causal) kend = min(Skv, q0 + nq);
    if (window > 0) kbeg = max(0, q0 - window + 1);
    kbeg = (kbeg / BN) * BN;
    const int ntiles = kend > kbeg ? (kend - kbeg + BN - 1) / BN : 0;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        mbar_init(full_bar, 1);
        mbar_init(full_bar + 8, 1);
        mbar_init(empty_bar, 8);
        mbar_init(empty_bar + 8, 8);
        mbar_init(q_bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp >= 8) {
        // the producer warpgroup: its first lane loads Q once, then the
        // K/V ring
        asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
        if (warp == 8 && lane == 0) {
            mbar_expect_tx(q_bar, (DP / 64) * rows * 128);
#pragma unroll
            for (int c = 0; c < DP / 64; ++c)
                tma_load_4d(sq + c * BM * 128, &qmap, q_bar, 64 * c, hk * g,
                            q0, b);
            for (int t = 0; t < ntiles; ++t) {
                const int s = t & 1;
                if (t >= 2) mbar_wait(empty_bar + 8 * s, ((t >> 1) - 1) & 1);
                mbar_expect_tx(full_bar + 8 * s, 2 * Lay::TILE);
                const int k0 = kbeg + t * BN;
#pragma unroll
                for (int c = 0; c < DP / 64; ++c) {
                    tma_load_4d(sk + s * Lay::TILE + c * BN * 128, &kmap,
                                full_bar + 8 * s, 64 * c, hk, k0, b);
                    tma_load_4d(sv + s * Lay::TILE + c * BN * 128, &vmap,
                                full_bar + 8 * s, 64 * c, hk, k0, b);
                }
            }
        }
    } else {
        // a consumer warpgroup: rows wg * 64 .. + 63; this thread's two rows
        asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
        const int wg = warp >> 2;
        const int ra = wg * 64 + (warp & 3) * 16 + (lane >> 2), rb = ra + 8;
        const int qa = q0 + ra / g, qb = q0 + rb / g;
        const float rcap2 = cap > 0.f ? 2.f * LOG2E / cap : 0.f;
        float acc[DP / 2];
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
        float m0 = FA_NEG, m1 = FA_NEG;     // running maxima of rows ra, rb
        float l0 = 0.f, l1 = 0.f;       // this thread's share of their sums
        const uint32_t sq_wg = sq + wg * 64 * 128;
        mbar_wait(q_bar, 0);

        for (int t = 0; t < ntiles; ++t) {
            const int s = t & 1;
            const int k0 = kbeg + t * BN;
            const uint32_t skt = sk + s * Lay::TILE, svt = sv + s * Lay::TILE;
            mbar_wait(full_bar + 8 * s, (t >> 1) & 1);

            // S = Q K^T: DP / 16 steps of 16 along D; 128-byte rows, so a step
            // inside a 64-column block moves the start address by 32 bytes
            float sc[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) sc[i] = 0.f;
            wgmma_fence_regs(sc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DP / 16; ++kk) {
                const int c = kk >> 2, ki = kk & 3;
                wgmma_m64n64k16_ss(
                    sc, wgmma_desc(sq_wg + c * BM * 128 + ki * 32, 16, 1024),
                    wgmma_desc(skt + c * BN * 128 + ki * 32, 16, 1024),
                    kk > 0);
            }
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_fence_regs(sc);

            // scale, cap, masks (on straddling tiles only), row maxima
            const bool edge = (causal && k0 + BN - 1 > q0)
                              || (window > 0 && k0 <= q0 + nq - 1 - window)
                              || k0 + BN > Skv;
            float mx0 = m0, mx1 = m1;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                float x = sc[i] * scale;
                if (cap > 0.f)
                    x = cap * (1.f - 2.f * rcp(1.f + ex2(x * rcap2)));
                if (edge) {
                    const int kj =
                        k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
                    const int qi = (i & 2) ? qb : qa;
                    bool ok = kj < Skv;
                    if (causal) ok = ok && kj <= qi;
                    if (window > 0) ok = ok && qi - kj < window;
                    if (!ok) x = FA_NEG;
                }
                sc[i] = x;
                if (i & 2)
                    mx1 = fmaxf(mx1, x);
                else
                    mx0 = fmaxf(mx0, x);
            }
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
            const float al0 = ex2((m0 - mx0) * LOG2E);
            const float al1 = ex2((m1 - mx1) * LOG2E);
            m0 = mx0;
            m1 = mx1;
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const float p = ex2((sc[i] - ((i & 2) ? m1 : m0)) * LOG2E);
                sc[i] = p;
                if (i & 2)
                    s1 += p;
                else
                    s0 += p;
            }
            l0 = l0 * al0 + s0;
            l1 = l1 * al1 + s1;
            // P in bf16 as the A operand: keys 16 kk .. 16 kk + 15 are the
            // accumulator registers 8 kk .. 8 kk + 7, already in A's layout
            uint32_t pa[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
                pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
                pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
                pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
            }
#pragma unroll
            for (int j = 0; j < DP / 8; ++j) {
                acc[4 * j + 0] *= al0;
                acc[4 * j + 1] *= al0;
                acc[4 * j + 2] *= al1;
                acc[4 * j + 3] *= al1;
            }

            // O += P V: 4 steps of 16 keys (2048 bytes of V rows each); V is
            // MN-major: 64-column blocks BN * 128 bytes apart, 8-key groups
            // 1024 bytes apart
            wgmma_fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                pv_product<DP>(acc, pa[kk],
                               wgmma_desc(svt + kk * 2048, BN * 128, 1024));
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_fence_regs(acc);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty_bar + 8 * s);
        }

        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
        __nv_bfloat16* oa =
            (ra < rows && ra / g < nq)
                ? o + (((size_t)b * Sq + qa) * Hq + hk * g + ra % g) * D
                : nullptr;
        __nv_bfloat16* ob =
            (rb < rows && rb / g < nq)
                ? o + (((size_t)b * Sq + qb) * Hq + hk * g + rb % g) * D
                : nullptr;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
            const int col = 8 * j + 2 * (lane & 3);
            if (col < D) {
                if (oa)
                    *reinterpret_cast<__nv_bfloat162*>(oa + col) =
                        __floats2bfloat162_rn(acc[4 * j] * i0,
                                              acc[4 * j + 1] * i0);
                if (ob)
                    *reinterpret_cast<__nv_bfloat162*>(ob + col) =
                        __floats2bfloat162_rn(acc[4 * j + 2] * i1,
                                              acc[4 * j + 3] * i1);
            }
        }
    }
}

typedef CUresult (*fa_encode_fn)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (so the
// library needs no link against libcuda)
static fa_encode_fn fa_encoder() {
    static fa_encode_fn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult qr;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &qr);
#else
        cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &qr);
#endif
        if (e == cudaSuccess && qr == cudaDriverEntryPointSuccess)
            fn = (fa_encode_fn)p;
    }
    return fn;
}

// a 4-D bf16 map over (D, H, S, B), contiguous, with a box of
// (64, bh, bs, 1): 128-byte rows, 128-byte swizzle, zero fill outside
static bool fa_map(CUtensorMap* map, const void* ptr, int D, int H, int S,
                   int B, int bh, int bs) {
    fa_encode_fn enc = fa_encoder();
    if (enc == nullptr) return false;
    cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                          (cuuint64_t)B};
    cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                             (cuuint64_t)S * H * D * 2};
    cuuint32_t box[4] = {64, (cuuint32_t)bh, (cuuint32_t)bs, 1};
    cuuint32_t estr[4] = {1, 1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<void*>(ptr), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
static int flash_wgmma_launch_t(const void* q, const void* k, const void* v,
                                void* o, int B, int Sq, int Skv, int Hq,
                                int Hkv, int D, int causal, int window,
                                float cap, float scale,
                                cudaStream_t stream) {
    const int g = Hq / Hkv;
    const int tq = fa::BM / g;
    CUtensorMap qm, km, vm;
    if (!fa_map(&qm, q, D, Hq, Sq, B, g, tq)
        || !fa_map(&km, k, D, Hkv, Skv, B, 1, fa::BN)
        || !fa_map(&vm, v, D, Hkv, Skv, B, 1, fa::BN))
        return (int)cudaErrorInvalidValue;
    const int smem = fa::Layout<DP>::BYTES;
    auto kern = flash_fwd_wgmma<DP>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(B * Hkv, (Sq + tq - 1) / tq);
    kern<<<grid, fa::THREADS, smem, stream>>>(
        qm, km, vm, (__nv_bfloat16*)o, Sq, Skv, Hq, Hkv, D, g, tq, causal,
        window, cap, scale);
    return (int)cudaGetLastError();
}

// bf16 q, k, v, o, contiguous and 16-byte aligned; window <= 0: none;
// cap <= 0: none.  The wrapper has checked D <= 256, D % 8 == 0,
// Hq % Hkv == 0 and Hq / Hkv <= 64.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int Sq, int Skv, int Hq, int Hkv,
                                           int D, int causal, int window,
                                           float cap, float scale,
                                           void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (D <= 64)
        return flash_wgmma_launch_t<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                        causal, window, cap, scale, s);
    if (D <= 128)
        return flash_wgmma_launch_t<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                         causal, window, cap, scale, s);
    return flash_wgmma_launch_t<256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                     causal, window, cap, scale, s);
}

// ---------------------------------------------------------------------------
// The wide form: any head dim D > 256, f32 or bf16 inputs, computed in f32
// on CUDA cores.  Both forms above keep a block's query rows (and the bf16
// form its K/V tiles) in shared memory sized by D, which does not fit past
// D = 256.  Semantics as the f32 form: q scaled by D**-0.5 in f32 before
// the product, f32 accumulation, cap before mask, the finite FA_NEG for
// masked scores, causal and window with key tiles outside them skipped,
// the online softmax, l floored at 1e-30; bf16 inputs are read as bf16 and
// converted, the output rounded to bf16 once.  On no path (no
// configuration has d_head > 256).
//
// flash_wide_kernel, D <= 1024 (launch count flash_attention_wide): one
// pass, a thread-block cluster split along D.  A cluster of
// n_c = ceil(D / DS) blocks (DS = 128 columns each, n_c <= 8, the portable
// cluster size) shares one query tile of FA_R = 64 folded rows; block r
// owns the columns [128 r, 128 r + 128).
//
//   - It stages its columns of the scaled Q tile in shared memory once for
//     the whole key loop.
//   - Per key tile of BK = 64 keys it loads its columns of K, computes the
//     partial scores over them (4 x 4 a thread, float4 shared loads along
//     D: 8 loads per 64 FMAs) and writes them to its own shared memory.
//   - One cluster barrier, in two halves: the block arrives, loads its
//     columns of V over K's while the others arrive, then waits.
//   - Each block sums the n_c partials through distributed shared memory
//     (cluster.map_shared_rank) in rank order 0 .. n_c - 1, so every block
//     of the cluster holds bit-identical scores, maxima, sums and
//     probabilities; it applies the cap and the masks, runs the online
//     softmax (a row's 64 keys over 4 lanes) and accumulates its 64 x 128
//     slice of O in registers (8 x 4 a thread).
//   - The partial-score buffers are double-buffered: a block rewrites a
//     buffer two tiles later, after the next barrier, by which every block
//     has read it, so one cluster barrier a key tile suffices; the
//     probabilities go to the buffer of the tile before, free by then.
//
// So each score is computed once, Q, K and V are read once per query tile,
// and there is one launch and no scratch in device memory.  Shared memory:
// 103 KB a block; two blocks an SM (<= 128 registers, which holding V in
// registers across the sum would exceed).
//
// Past D = 1024 the two-pass form below runs (flash_wide_stats +
// flash_wide_out, launch count flash_attention_wide_2pass): its shared
// memory is fixed in D, at the price of computing S = Q K^T 1 + D / 128
// times.
#include <cooperative_groups.h>

namespace fw {

namespace cg = cooperative_groups;

constexpr int DS = 128;                 // D columns a block of the cluster
constexpr int BK = 64;                  // keys a tile
constexpr int MAX_CLUSTER = 8;          // D <= DS * MAX_CLUSTER = 1024
constexpr int ST = DS + 4;              // row stride of the Q, K, V slices
constexpr int PS = BK + 4;              // row stride of the score buffers
// q [FA_R][ST], k or v [BK][ST], two score buffers [FA_R][PS], m, l, alpha
constexpr int SMEM_FLOATS = FA_R * ST + BK * ST + 2 * FA_R * PS + 3 * FA_R;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

// n (<= 4) elements from p as a float4, zeros past them; vec: all four,
// one aligned vector load
__device__ __forceinline__ float4 load4(const float* p, int n, bool vec) {
    if (vec && n >= 4) return *reinterpret_cast<const float4*>(p);
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = i < n ? p[i] : 0.f;
    return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int n,
                                        bool vec) {
    if (vec && n >= 4) {
        const uint2 raw = *reinterpret_cast<const uint2*>(p);
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        return make_float4(a.x, a.y, b.x, b.y);
    }
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = i < n ? __bfloat162float(p[i]) : 0.f;
    return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ float4 scale4(float4 x, float s) {
    return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int Sq,
                  int Skv, int Hq, int Hkv, int D, int g, int tq, int causal,
                  int window, float cap, float scale, int vec) {
    cg::cluster_group cl = cg::this_cluster();
    const int nc = (int)cl.num_blocks(), rank = (int)cl.block_rank();
    extern __shared__ float4 fw_sm4[];
    float* q_sh = reinterpret_cast<float*>(fw_sm4);    // [FA_R][ST]
    float* kv_sh = q_sh + FA_R * ST;                    // [BK][ST]
    float* ps_sh = kv_sh + BK * ST;                     // [2][FA_R][PS]
    float* m_sh = ps_sh + 2 * FA_R * PS;                // [FA_R]
    float* l_sh = m_sh + FA_R;                          // [FA_R]
    float* a_sh = l_sh + FA_R;                          // [FA_R]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int bh = blockIdx.x / nc;
    const int b = bh / Hkv, hk = bh % Hkv;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * tq;  // latest tiles first
    const int nq = min(tq, Sq - q0);
    const int rows = tq * g;
    const int d0 = rank * DS;                           // this block's columns
    const bool vv = vec != 0;

    // the scaled Q slice, zero past the valid rows and past D
    for (int e = tid; e < FA_R * DS / 4; e += FA_THREADS) {
        const int r = e >> 5, d = d0 + 4 * (e & 31);
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows && r / g < nq && d < D) {
            const int qi = q0 + r / g, h = hk * g + r % g;
            x = scale4(load4(q + (((size_t)b * Sq + qi) * Hq + h) * D + d,
                             D - d, vv), scale);
        }
        *reinterpret_cast<float4*>(q_sh + r * ST + 4 * (e & 31)) = x;
    }
    for (int r = tid; r < FA_R; r += FA_THREADS) {
        m_sh[r] = FA_NEG;
        l_sh[r] = 0.f;
    }
    // this block's K or V slice of key tile k0 (8 float4 a thread)
    auto load_kv = [&](const T* src, int k0, float4* x) {
#pragma unroll
        for (int i = 0; i < BK * DS / 4 / FA_THREADS; ++i) {
            const int e = tid + FA_THREADS * i;
            const int j = e >> 5, d = d0 + 4 * (e & 31), kj = k0 + j;
            x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (kj < Skv && d < D)
                x[i] = load4(src + (((size_t)b * Skv + kj) * Hkv + hk) * D + d,
                             D - d, vv);
        }
    };
    auto store_kv = [&](const float4* x) {
#pragma unroll
        for (int i = 0; i < BK * DS / 4 / FA_THREADS; ++i) {
            const int e = tid + FA_THREADS * i;
            *reinterpret_cast<float4*>(kv_sh + (e >> 5) * ST
                                       + 4 * (e & 31)) = x[i];
        }
    };

    // O slice: rows warp + 8 i, columns 4 lane + j of this block's DS
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    // key tiles that hold an unmasked (valid query, key) pair
    int kbeg = 0, kend = Skv;
    if (causal) kend = min(Skv, q0 + nq);
    if (window > 0) kbeg = max(0, q0 - window + 1);
    kbeg = (kbeg / BK) * BK;

    const int tr = tid >> 4, tc = tid & 15;     // score tile: rows tr + 16 i,
                                                // keys tc + 16 j
    const int sr = tid >> 2, sq = tid & 3;      // softmax: row sr, keys
                                                // 16 sq .. 16 sq + 15
    int buf = 0;
    for (int k0 = kbeg; k0 < kend; k0 += BK, buf ^= 1) {
        __syncthreads();                // the last tile's V and P are read
        {
            float4 x[BK * DS / 4 / FA_THREADS];
            load_kv(k, k0, x);
            store_kv(x);
        }
        __syncthreads();
        // this block's partial scores over its columns
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
        for (int dd = 0; dd < DS; dd += 4) {
            float4 qa[4], ka[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                qa[i] = *reinterpret_cast<const float4*>(
                    q_sh + (tr + 16 * i) * ST + dd);
                ka[i] = *reinterpret_cast<const float4*>(
                    kv_sh + (tc + 16 * i) * ST + dd);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float x = s[i][j];
                    x = fmaf(qa[i].x, ka[j].x, x);
                    x = fmaf(qa[i].y, ka[j].y, x);
                    x = fmaf(qa[i].z, ka[j].z, x);
                    x = fmaf(qa[i].w, ka[j].w, x);
                    s[i][j] = x;
                }
        }
        float* part = ps_sh + buf * FA_R * PS;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                part[(tr + 16 * i) * PS + tc + 16 * j] = s[i][j];
        // the cluster barrier in two halves: arrive once this block's
        // partials are written, load this tile's V slice over K's while the
        // other blocks arrive (K's readers are this block's own threads),
        // then wait until every block's partials are written
        asm volatile("barrier.cluster.arrive.release.aligned;\n" ::);
        __syncthreads();
        {
            float4 x[BK * DS / 4 / FA_THREADS];
            load_kv(v, k0, x);
            store_kv(x);
        }
        asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::);
        // the scores of row sr, keys 16 sq + t: the partials summed in
        // rank order
        float sc[16];
        {
            const float* p0 = cl.map_shared_rank(part, 0) + sr * PS + 16 * sq;
#pragma unroll
            for (int t = 0; t < 16; t += 4) {
                const float4 x = *reinterpret_cast<const float4*>(p0 + t);
                sc[t] = x.x;
                sc[t + 1] = x.y;
                sc[t + 2] = x.z;
                sc[t + 3] = x.w;
            }
        }
        for (int rk = 1; rk < nc; ++rk) {
            const float* pr = cl.map_shared_rank(part, rk) + sr * PS + 16 * sq;
#pragma unroll
            for (int t = 0; t < 16; t += 4) {
                const float4 x = *reinterpret_cast<const float4*>(pr + t);
                sc[t] += x.x;
                sc[t + 1] += x.y;
                sc[t + 2] += x.z;
                sc[t + 3] += x.w;
            }
        }
        // cap, then masks
        const int qi = q0 + sr / g;
        float mx = FA_NEG;
#pragma unroll
        for (int t = 0; t < 16; ++t) {
            const int kj = k0 + 16 * sq + t;
            float x = sc[t];
            if (cap > 0.f) x = cap * tanhf(x / cap);
            const int dp = qi - kj;
            bool ok = kj < Skv;
            if (causal) ok = ok && dp >= 0;
            if (window > 0) ok = ok && dp < window;
            sc[t] = ok ? x : FA_NEG;
            mx = fmaxf(mx, sc[t]);
        }
        // the online softmax of row sr over its four lanes
        const float m_prev = m_sh[sr];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        float* pp = ps_sh + (buf ^ 1) * FA_R * PS + sr * PS + 16 * sq;
#pragma unroll
        for (int t = 0; t < 16; t += 4) {
            float4 p;
            p.x = expf(sc[t] - m_new);
            p.y = expf(sc[t + 1] - m_new);
            p.z = expf(sc[t + 2] - m_new);
            p.w = expf(sc[t + 3] - m_new);
            sum += p.x + p.y + p.z + p.w;
            *reinterpret_cast<float4*>(pp + t) = p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (sq == 0) {
            const float alpha = expf(m_prev - m_new);
            l_sh[sr] = l_sh[sr] * alpha + sum;
            m_sh[sr] = m_new;
            a_sh[sr] = alpha;
        }
        __syncthreads();                // P, alpha and V are written
        // O = O * alpha + P V
        const float* pm = ps_sh + (buf ^ 1) * FA_R * PS;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float alpha = a_sh[warp + 8 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
        }
#pragma unroll 4
        for (int kk = 0; kk < BK; kk += 4) {
            float4 vb[4];
#pragma unroll
            for (int t = 0; t < 4; ++t)
                vb[t] = *reinterpret_cast<const float4*>(
                    kv_sh + (kk + t) * ST + 4 * lane);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float4 p = *reinterpret_cast<const float4*>(
                    pm + (warp + 8 * i) * PS + kk);
                const float pt[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    acc[i][0] += pt[t] * vb[t].x;
                    acc[i][1] += pt[t] * vb[t].y;
                    acc[i][2] += pt[t] * vb[t].z;
                    acc[i][3] += pt[t] * vb[t].w;
                }
            }
        }
    }
    cl.sync();                          // no block reads this one's buffers
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = warp + 8 * i;
        if (r >= rows || r / g >= nq) continue;
        const int qi = q0 + r / g, h = hk * g + r % g;
        const float den = fmaxf(l_sh[r], 1e-30f);
        T* orow = o + (((size_t)b * Sq + qi) * Hq + h) * D;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int d = d0 + 4 * lane + j;
            if (d < D) fa_store(orow + d, acc[i][j] / den);
        }
    }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                  int window, float cap, float scale, cudaStream_t stream) {
    const int g = Hq / Hkv;
    const int tq = FA_R / g;
    const int nc = (D + DS - 1) / DS;
    if (nc < 1 || nc > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
    // one aligned vector load per 4 elements: D % 4 == 0 and aligned bases
    const size_t al = 4 * sizeof(T);
    const int vec = D % 4 == 0 && (size_t)q % al == 0 && (size_t)k % al == 0
                    && (size_t)v % al == 0;
    cudaError_t err = cudaFuncSetAttribute(
        flash_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(nc * B * Hkv), (Sq + tq - 1) / tq, 1);
    cfg.blockDim = dim3(FA_THREADS, 1, 1);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)nc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, flash_wide_kernel<T>, (const T*)q,
                             (const T*)k, (const T*)v, (T*)o, Sq, Skv, Hq,
                             Hkv, D, g, tq, causal, window, cap, scale, vec);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace fw

// f32 (bf16 == 0) or bf16 q, k, v, o, contiguous; window <= 0: none;
// cap <= 0: none.  The wrapper has checked 256 < D <= 1024,
// Hq % Hkv == 0 and Hq / Hkv <= FA_R.
extern "C" int flash_attention_wide_launch(const void* q, const void* k,
                                           const void* v, void* o, int B,
                                           int Sq, int Skv, int Hq, int Hkv,
                                           int D, int causal, int window,
                                           float cap, float scale, int bf16,
                                           void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return fw::launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                         causal, window, cap, scale, s);
    return fw::launch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal,
                             window, cap, scale, s);
}

// ---------------------------------------------------------------------------
// The two-pass wide form, D > 1024 (flash_wide_stats + flash_wide_out,
// launch count flash_attention_wide_2pass), the rows folded as in the f32
// form (FA_R = 64 rows, key tiles of FA_TK = 32):
//
//   flash_wide_stats: grid (B x Hkv, query tiles).  For each key tile it
//     computes the 64 x 32 scores over D in chunks of FW_DC columns of the
//     scaled q and of k staged in shared memory, applies the cap and the
//     masks, and updates each row's running max m and sum l (the f32
//     form's online softmax without the accumulator); it writes the final
//     m and l of each row to the scratch ml (2, B, Sq, Hq).
//   flash_wide_out: grid (B x Hkv, query tiles, D / FW_DO).  Each block
//     owns FW_DO output columns: it recomputes each key tile's scores the
//     same way, takes p = exp(s - m) with m already final (no rescaling),
//     stages its FW_DO columns of the v tile and accumulates p v in
//     registers, then writes acc / max(l, 1e-30).
//
// Its shared memory (~50 KB) is fixed whatever D.
#define FW_DC 64           // D columns of q and k staged per chunk
#define FW_DO 128          // output columns per block of the second pass
#define FW_QS (FW_DC + 1)  // padded row stride of the staged chunks

constexpr int fw_smem_floats(bool out_pass) {
    return FA_R * FW_QS + FA_TK * FW_QS + FA_R * (FA_TK + 1) + 2 * FA_R
           + (out_pass ? FA_TK * FW_DO : 0);
}

// The scores of rows tr*4 + i, key columns tc and tc + 16 of key tile k0,
// over all of D (q scaled), capped and masked, into p_sh.  Leaves the
// block synchronised.
template <typename T>
__device__ __forceinline__ void fw_scores(
        const T* __restrict__ q, const T* __restrict__ k, float* q_sh,
        float* k_sh, float* p_sh, int b, int hk, int q0, int nq, int rows,
        int k0, int Sq, int Skv, int Hq, int Hkv, int D, int g, int causal,
        int window, float cap, float scale) {
    const int tid = threadIdx.x;
    const int tr = tid >> 4, tc = tid & 15;
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d0 = 0; d0 < D; d0 += FW_DC) {
        __syncthreads();            // the last chunk (or tile) is read
        for (int e = tid; e < FA_R * FW_DC; e += FA_THREADS) {
            const int r = e / FW_DC, d = d0 + e % FW_DC;
            float x = 0.f;
            if (r < rows && r / g < nq && d < D) {
                const int qi = q0 + r / g, h = hk * g + r % g;
                x = fa_load(q + (((size_t)b * Sq + qi) * Hq + h) * D + d)
                    * scale;
            }
            q_sh[r * FW_QS + e % FW_DC] = x;
        }
        for (int e = tid; e < FA_TK * FW_DC; e += FA_THREADS) {
            const int j = e / FW_DC, d = d0 + e % FW_DC;
            const int kj = k0 + j;
            k_sh[j * FW_QS + e % FW_DC] =
                (kj < Skv && d < D)
                    ? fa_load(k + (((size_t)b * Skv + kj) * Hkv + hk) * D + d)
                    : 0.f;
        }
        __syncthreads();
#pragma unroll 1
        for (int d = 0; d < FW_DC; ++d) {
            const float k0v = k_sh[tc * FW_QS + d];
            const float k1v = k_sh[(tc + 16) * FW_QS + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float qv = q_sh[(tr * 4 + i) * FW_QS + d];
                s[i][0] += qv * k0v;
                s[i][1] += qv * k1v;
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i;
        const int qi = q0 + r / g;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
            const int c = tc + 16 * jj;
            const int kj = k0 + c;
            float x = s[i][jj];
            if (cap > 0.f) x = cap * tanhf(x / cap);
            const int dp = qi - kj;
            bool ok = kj < Skv;
            if (causal) ok = ok && dp >= 0;
            if (window > 0) ok = ok && dp < window;
            p_sh[r * (FA_TK + 1) + c] = ok ? x : FA_NEG;
        }
    }
    __syncthreads();
}

// key tiles that hold an unmasked (valid query, key) pair, as the f32 form
__device__ __forceinline__ void fw_key_range(int q0, int nq, int Skv,
                                             int causal, int window,
                                             int* kbeg, int* kend) {
    int b0 = 0, e0 = Skv;
    if (causal) e0 = min(Skv, q0 + nq);
    if (window > 0) b0 = max(0, q0 - window + 1);
    *kbeg = (b0 / FA_TK) * FA_TK;
    *kend = e0;
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
flash_wide_stats(const T* __restrict__ q, const T* __restrict__ k,
                 float* __restrict__ ml, int B, int Sq, int Skv, int Hq,
                 int Hkv, int D, int g, int tq, int causal, int window,
                 float cap, float scale) {
    extern __shared__ float smem[];
    float* q_sh = smem;                         // [FA_R][FW_QS]
    float* k_sh = q_sh + FA_R * FW_QS;          // [FA_TK][FW_QS]
    float* p_sh = k_sh + FA_TK * FW_QS;         // [FA_R][FA_TK + 1]
    float* m_sh = p_sh + FA_R * (FA_TK + 1);    // [FA_R]
    float* l_sh = m_sh + FA_R;                  // [FA_R]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
    const int q0 = blockIdx.y * tq;
    const int nq = min(tq, Sq - q0);
    const int rows = tq * g;
    for (int r = tid; r < FA_R; r += FA_THREADS) {
        m_sh[r] = FA_NEG;
        l_sh[r] = 0.f;
    }
    int kbeg, kend;
    fw_key_range(q0, nq, Skv, causal, window, &kbeg, &kend);
    for (int k0 = kbeg; k0 < kend; k0 += FA_TK) {
        fw_scores(q, k, q_sh, k_sh, p_sh, b, hk, q0, nq, rows, k0, Sq, Skv,
                  Hq, Hkv, D, g, causal, window, cap, scale);
        // warp w takes rows 8w .. 8w+7, lane = key column
        for (int i = 0; i < 8; ++i) {
            const int r = warp * 8 + i;
            const float x = p_sh[r * (FA_TK + 1) + lane];
            float mx = x;
            for (int off = 16; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_prev = m_sh[r];
            const float m_new = fmaxf(m_prev, mx);
            float sum = expf(x - m_new);
            for (int off = 16; off > 0; off >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            if (lane == 0) {
                l_sh[r] = l_sh[r] * expf(m_prev - m_new) + sum;
                m_sh[r] = m_new;
            }
        }
    }
    __syncthreads();
    const size_t plane = (size_t)B * Sq * Hq;
    for (int r = tid; r < rows; r += FA_THREADS) {
        if (r / g >= nq) continue;
        const size_t idx =
            ((size_t)b * Sq + q0 + r / g) * Hq + hk * g + r % g;
        ml[idx] = m_sh[r];
        ml[plane + idx] = l_sh[r];
    }
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
flash_wide_out(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ ml,
               T* __restrict__ o, int B, int Sq, int Skv, int Hq, int Hkv,
               int D, int g, int tq, int causal, int window, float cap,
               float scale) {
    extern __shared__ float smem[];
    float* q_sh = smem;                         // [FA_R][FW_QS]
    float* k_sh = q_sh + FA_R * FW_QS;          // [FA_TK][FW_QS]
    float* p_sh = k_sh + FA_TK * FW_QS;         // [FA_R][FA_TK + 1]
    float* m_sh = p_sh + FA_R * (FA_TK + 1);    // [FA_R] final max
    float* l_sh = m_sh + FA_R;                  // [FA_R] final sum
    float* v_sh = l_sh + FA_R;                  // [FA_TK][FW_DO]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
    const int q0 = blockIdx.y * tq;
    const int nq = min(tq, Sq - q0);
    const int rows = tq * g;
    const int c0 = blockIdx.z * FW_DO;          // this block's columns
    const size_t plane = (size_t)B * Sq * Hq;
    for (int r = tid; r < FA_R; r += FA_THREADS) {
        float m = FA_NEG, l = 1.f;
        if (r < rows && r / g < nq) {
            const size_t idx =
                ((size_t)b * Sq + q0 + r / g) * Hq + hk * g + r % g;
            m = ml[idx];
            l = ml[plane + idx];
        }
        m_sh[r] = m;
        l_sh[r] = l;
    }
    float acc[8][FW_DO / 32];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < FW_DO / 32; ++j) acc[i][j] = 0.f;
    int kbeg, kend;
    fw_key_range(q0, nq, Skv, causal, window, &kbeg, &kend);
    for (int k0 = kbeg; k0 < kend; k0 += FA_TK) {
        fw_scores(q, k, q_sh, k_sh, p_sh, b, hk, q0, nq, rows, k0, Sq, Skv,
                  Hq, Hkv, D, g, causal, window, cap, scale);
        // p = exp(s - m) with the final m, and this block's v columns
        for (int e = tid; e < FA_R * FA_TK; e += FA_THREADS) {
            const int r = e / FA_TK, c = e % FA_TK;
            p_sh[r * (FA_TK + 1) + c] =
                expf(p_sh[r * (FA_TK + 1) + c] - m_sh[r]);
        }
        for (int e = tid; e < FA_TK * FW_DO; e += FA_THREADS) {
            const int j = e / FW_DO, d = c0 + e % FW_DO;
            const int kj = k0 + j;
            v_sh[e] = (kj < Skv && d < D)
                ? fa_load(v + (((size_t)b * Skv + kj) * Hkv + hk) * D + d)
                : 0.f;
        }
        __syncthreads();
        // acc += p v: rows warp + 8 i, columns lane + 32 j
        for (int c = 0; c < FA_TK; ++c) {
            float vv[FW_DO / 32];
#pragma unroll
            for (int j = 0; j < FW_DO / 32; ++j)
                vv[j] = v_sh[c * FW_DO + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float p = p_sh[(warp + 8 * i) * (FA_TK + 1) + c];
#pragma unroll
                for (int j = 0; j < FW_DO / 32; ++j) acc[i][j] += p * vv[j];
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = warp + 8 * i;
        if (r >= rows || r / g >= nq) continue;
        const int qi = q0 + r / g, h = hk * g + r % g;
        const float den = fmaxf(l_sh[r], 1e-30f);
        T* orow = o + (((size_t)b * Sq + qi) * Hq + h) * D;
#pragma unroll
        for (int j = 0; j < FW_DO / 32; ++j) {
            const int d = c0 + lane + 32 * j;
            if (d < D) fa_store(orow + d, acc[i][j] / den);
        }
    }
}

template <typename T>
static int flash_wide_launch_t(const void* q, const void* k, const void* v,
                               void* o, float* ml, int B, int Sq, int Skv,
                               int Hq, int Hkv, int D, int causal,
                               int window, float cap, float scale,
                               cudaStream_t stream) {
    const int g = Hq / Hkv;
    const int tq = FA_R / g;
    const int smem1 = fw_smem_floats(false) * (int)sizeof(float);
    const int smem2 = fw_smem_floats(true) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_wide_stats<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem1);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            flash_wide_out<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem2);
    if (err != cudaSuccess) return (int)err;
    dim3 grid1(B * Hkv, (Sq + tq - 1) / tq);
    flash_wide_stats<T><<<grid1, FA_THREADS, smem1, stream>>>(
        (const T*)q, (const T*)k, ml, B, Sq, Skv, Hq, Hkv, D, g, tq, causal,
        window, cap, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dim3 grid2(B * Hkv, (Sq + tq - 1) / tq, (D + FW_DO - 1) / FW_DO);
    flash_wide_out<T><<<grid2, FA_THREADS, smem2, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, ml, (T*)o, B, Sq, Skv, Hq, Hkv,
        D, g, tq, causal, window, cap, scale);
    return (int)cudaGetLastError();
}

// f32 (bf16 == 0) or bf16 q, k, v, o, contiguous; ml: f32 scratch of
// 2 B Sq Hq floats; window <= 0: none; cap <= 0: none.  The wrapper has
// checked D > 1024, Hq % Hkv == 0 and Hq / Hkv <= FA_R.
extern "C" int flash_attention_wide_2pass_launch(
        const void* q, const void* k, const void* v, void* o, void* ml, int B,
        int Sq, int Skv, int Hq, int Hkv, int D, int causal, int window,
        float cap, float scale, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16)
        return flash_wide_launch_t<__nv_bfloat16>(
            q, k, v, o, (float*)ml, B, Sq, Skv, Hq, Hkv, D, causal, window,
            cap, scale, s);
    return flash_wide_launch_t<float>(q, k, v, o, (float*)ml, B, Sq, Skv, Hq,
                                      Hkv, D, causal, window, cap, scale, s);
}
