// K9: fused attention forward with online softmax (GQA, causal, sliding
// window, score soft-cap).  q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D)
// -> o (B, Sq, Hq, D) in q's type.  Positions are implicit: query row i
// attends key rows <= i (causal) and > i - window.  Two forms
// (kernels/flash_attention.py:k9_form picks):
//
//   bfloat16, D <= 256  flash_fwd_wgmma: tensor cores (wgmma), K/V tiles
//                       by TMA (first below);
//   otherwise           fw::flash_f32_kernel: f32 arithmetic on CUDA
//                       cores, any head dim, f32 or bf16 inputs (at the
//                       end of the file); the f32 tolerance (1e-4) is
//                       below what bf16 or TF32 products reach.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas
// (its Pallas kernel body).  Bound on this card: operations -- 4 D per
// unmasked (query head, key) pair, against q, k, v and o read or written
// once (at gemma2-2b's B = 2, S = 8192, Hq = 8, Hkv = 4, D = 256 a global
// layer is ~0.55 TFLOP against ~0.2 GB).  Both forms fold the g query
// heads of a kv head into a block's rows as the Pallas kernel folds them
// into its tile rows (row r = query q0 + r / g, head hk g + r % g), so a
// K/V tile is read once for all g heads; key tiles wholly outside the
// causal wedge or the window are never loaded; ragged Sq and Skv are
// bounds checks (f32 arithmetic) or the TMA's zero fill (bf16); nothing
// is padded in device memory.
//
// Semantics of the reference kept: cap * tanh(s / cap) before the mask;
// masked scores take the finite -2.3819763e38 (so a row's first
// all-masked tile is wiped by the first real score's alpha = 0, as in
// the reference); l is floored at 1e-30 in the final divide.  The
// f32-arithmetic form scales q by D**-0.5 in f32 before the product, as
// the reference.  The D-sum and the key-sum run in another order than the
// plain version's, so the two agree to a tolerance, not bit for bit.
#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"
#include "wgmma.cuh"

#define FA_R 64            // folded (query, head) rows per block
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
// The f32-arithmetic form (launch count flash_attention_f32): every f32
// call, at any head dim, and every bf16 call past D = 256, computed in f32
// on CUDA cores; bf16 inputs are read as bf16 and converted, the output
// rounded to bf16 once.  Semantics as the reference: q scaled by D**-0.5
// in f32 before the product, f32 accumulation, cap before mask, the
// finite FA_NEG for masked scores, causal and window with key tiles
// outside them skipped, the online softmax, l floored at 1e-30.
//
// D is cut into n_ch = ceil(D / DS) chunks of DS = 128 columns.  A
// thread-block cluster of n_c blocks shares one query tile of FA_R = 64
// folded rows, and the grid's z dimension splits the output columns into
// n_g groups:
//
//   n_g = ceil(n_ch / MAX_CLUSTER),   n_c = ceil(n_ch / n_g),
//
// MAX_CLUSTER = 16 being the H100's non-portable cluster size (past 8
// blocks the launch allows it with
// cudaFuncAttributeNonPortableClusterSizeAllowed).  So up to D = 2048 one
// cluster covers D: n_c = 1 at D <= 128, 2 at D <= 256 (gemma2-2b's f32
// layers), 9 at D = 1100, 16 at D = 2048.  Block r of group z
//
//   - owns the output chunk z n_c + r (none when that is past n_ch): its
//     64 x 128 slice of O, accumulated in registers (8 x 4 a thread);
//   - computes partial scores over the chunks r, r + n_c, r + 2 n_c, ...
//     < n_ch, in that order (4 x 4 a thread, float4 shared loads along D:
//     8 loads per 64 FMAs);
//   - owns the softmax of rows [r R, r R + R), R = ceil(64 / n_c): it sums
//     their n_c partial scores through distributed shared memory
//     (cluster.map_shared_rank) in rank order 0 .. n_c - 1, applies the
//     cap and the masks and runs their online softmax (a row's 64 keys
//     over 4 lanes), keeping their m and l.
//
// The score chunks of a rank are the same in every group, so every group
// computes the same scores and softmax, bit for bit, each score being
// computed n_g = ceil(D / 2048) times: once up to D = 2048.  Every block
// of a cluster takes its probabilities and rescale factors from the rows'
// owners, so all hold the same ones.
//
// Per key tile of BK = 64 keys: the block stages its score chunks of K
// (with one score chunk, up to D = 2048, its slice of the scaled Q tile
// stays in shared memory for the whole key loop; past it the Q chunk is
// staged beside each K chunk) and writes its partial scores to its own
// shared memory.  Cluster barrier A, in two halves: the block arrives,
// loads its chunk of V over K's while the others arrive, then waits.  The
// owners' softmax writes each row's probabilities and rescale factor
// (column 64) over the row's partials in the owner's buffer.  Cluster
// barrier B; each block copies the 64 rows from their owners into its
// other buffer and accumulates O = O * alpha + P V.  Each block reads
// 64 x 64 partials and 64 x 64 probabilities through distributed shared
// memory a tile, whatever n_c (a first design in which every block summed
// all n_c partials of every row read n_c times as many; it ran D = 1100
// at 2.70 ms and D = 2048 at 8.19 ms, scripts/k9_probe.py on one H100).
// The buffers are double-buffered by tile: a block rewrites a buffer two
// barriers after every other block has read it.  With n_c = 1 barrier B
// is a block barrier and P is read where it was written.
//
// One launch and no scratch in device memory; Q, K and V are read once
// per query tile and group.  Shared memory: 103 KB a block, two blocks an
// SM at <= 128 registers.
//
// Two designs measured against this one on one H100 (700 W;
// scripts/k9_probe.py, the same call): K and V staged by cp.async into a
// second buffer while the scores are computed (137 KB a block, one block
// an SM) ran 22.6 ms against 19.0 at gemma2-2b's global layer in f32
// (D = 256, S = 8192) and 2.34 against 1.82 ms at D = 512, S = 2048, both
// slower: the second block an SM hides the loads better than the copy
// engine does.  A block owning 256 columns (no cluster at D = 256) was not
// built: its 8 x 8 output tile and 4 x 8 score tile need more than the
// 128 registers of two blocks an SM, and its Q and K slices 2 x 66 KB.
#include <cooperative_groups.h>

namespace fw {

namespace cg = cooperative_groups;

constexpr int DS = 128;                 // D columns of a chunk
constexpr int BK = 64;                  // keys a tile
constexpr int MAX_CLUSTER = 16;         // blocks a cluster (non-portable > 8)
constexpr int ST = DS + 4;              // row stride of the Q, K, V slices
constexpr int PS = BK + 4;              // row stride of the score buffers;
                                        // column BK holds a row's alpha
// float4s of a K or V slice each thread stages
constexpr int KV_VEC = BK * DS / 4 / FA_THREADS;
static_assert(DS == 128 && KV_VEC == 8, "the staging loops index by 32");
// q [FA_R][ST], k or v [BK][ST], two score buffers [FA_R][PS], m, l
constexpr int SMEM_BYTES = 4 * (FA_R * ST + BK * ST + 2 * FA_R * PS
                                + 2 * FA_R);

// the split of D: n_ch chunks, n_g column groups, n_c blocks a cluster
struct Split {
    int nch, ng, nc;
};
inline Split split_d(int D) {
    const int nch = (D + DS - 1) / DS;
    const int ng = (nch + MAX_CLUSTER - 1) / MAX_CLUSTER;
    return {nch, ng, (nch + ng - 1) / ng};
}

__device__ __forceinline__ float4 load4v(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4v(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

// n (<= 4) elements from p as a float4, zeros past them; vec: all four,
// one aligned vector load
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, int n, bool vec) {
    if (vec && n >= 4) return load4v(p);
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = i < n ? fa_load(p + i) : 0.f;
    return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ float4 scale4(float4 x, float s) {
    return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq,
                 int Skv, int Hq, int Hkv, int D, int g, int tq, int causal,
                 int window, float cap, float scale, int vec) {
    cg::cluster_group cl = cg::this_cluster();
    const int nc = (int)cl.num_blocks(), rank = (int)cl.block_rank();
    const int nch = (D + DS - 1) / DS;
    extern __shared__ float4 fw_sm4[];
    float* q_sh = reinterpret_cast<float*>(fw_sm4);    // [FA_R][ST]
    float* kv_sh = q_sh + FA_R * ST;                    // [BK][ST]
    float* ps_sh = kv_sh + BK * ST;                     // [2][FA_R][PS]
    float* m_sh = ps_sh + 2 * FA_R * PS;                // [FA_R]
    float* l_sh = m_sh + FA_R;                          // [FA_R]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int bh = blockIdx.x / nc;
    const int b = bh / Hkv, hk = bh % Hkv;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * tq;  // latest tiles first
    const int nq = min(tq, Sq - q0);
    const int rows = tq * g;
    const int oc = blockIdx.z * nc + rank;              // output chunk
    const bool owns = oc < nch;
    const int o0 = oc * DS;
    // one score chunk, which is then the output chunk: Q stays staged
    const bool resident = nch <= nc;
    const int rpb = (FA_R + nc - 1) / nc;               // softmax rows a block
    const bool vv = vec != 0;

    // the scaled Q slice of columns [c0, c0 + DS), zero past the valid
    // rows and past D
    auto stage_q = [&](int c0) {
        for (int e = tid; e < FA_R * DS / 4; e += FA_THREADS) {
            const int r = e >> 5, d = c0 + 4 * (e & 31);
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (r < rows && r / g < nq && d < D) {
                const int qi = q0 + r / g, h = hk * g + r % g;
                x = scale4(load4(q + (((size_t)b * Sq + qi) * Hq + h) * D + d,
                                 D - d, vv), scale);
            }
            *reinterpret_cast<float4*>(q_sh + r * ST + 4 * (e & 31)) = x;
        }
    };
    // columns [c0, c0 + DS) of key tile k0 of K or V into kv_sh, through
    // registers (8 float4 a thread)
    auto stage_kv = [&](const T* src, int k0, int c0) {
        float4 x[KV_VEC];
#pragma unroll
        for (int i = 0; i < KV_VEC; ++i) {
            const int e = tid + FA_THREADS * i;
            const int j = e >> 5, d = c0 + 4 * (e & 31), kj = k0 + j;
            x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (kj < Skv && d < D)
                x[i] = load4(src + (((size_t)b * Skv + kj) * Hkv + hk) * D + d,
                             D - d, vv);
        }
#pragma unroll
        for (int i = 0; i < KV_VEC; ++i) {
            const int e = tid + FA_THREADS * i;
            *reinterpret_cast<float4*>(kv_sh + (e >> 5) * ST
                                       + 4 * (e & 31)) = x[i];
        }
    };

    for (int r = tid; r < FA_R; r += FA_THREADS) {
        m_sh[r] = FA_NEG;
        l_sh[r] = 0.f;
    }
    // O slice: rows warp + 8 i, columns 4 lane + j of the output chunk
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
    const bool soft = sr >= rank * rpb && sr < (rank + 1) * rpb;

    if (resident) stage_q(o0);
    int buf = 0;
    for (int k0 = kbeg; k0 < kend; k0 += BK, buf ^= 1) {
        // this block's partial scores over its score chunks
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int c = rank; c < nch; c += nc) {
            __syncthreads();            // V, P (or the last chunk) are read
            if (!resident) stage_q(c * DS);
            stage_kv(k, k0, c * DS);
            __syncthreads();
#pragma unroll 2
            for (int dd = 0; dd < DS; dd += 4) {
                float4 ka[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    ka[j] = *reinterpret_cast<const float4*>(
                        kv_sh + (tc + 16 * j) * ST + dd);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float4 qa = *reinterpret_cast<const float4*>(
                        q_sh + (tr + 16 * i) * ST + dd);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        float x = s[i][j];
                        x = fmaf(qa.x, ka[j].x, x);
                        x = fmaf(qa.y, ka[j].y, x);
                        x = fmaf(qa.z, ka[j].z, x);
                        x = fmaf(qa.w, ka[j].w, x);
                        s[i][j] = x;
                    }
                }
            }
        }
        float* part = ps_sh + buf * FA_R * PS;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                part[(tr + 16 * i) * PS + tc + 16 * j] = s[i][j];
        // barrier A in two halves: arrive once this block's partials are
        // written, load this tile's V chunk over K while the other blocks
        // arrive (K's readers are this block's own threads), then wait
        // until every block's partials are written
        cluster_arrive();
        __syncthreads();
        if (owns) stage_kv(v, k0, o0);
        cluster_wait();
        if (soft) {
            // row sr, keys 16 sq + t: the partials summed in rank order
            float sc[16];
            {
                const float* p0 =
                    cl.map_shared_rank(part, 0) + sr * PS + 16 * sq;
#pragma unroll
                for (int t = 0; t < 16; t += 4) {
                    const float4 x = *reinterpret_cast<const float4*>(p0 + t);
                    sc[t] = x.x;
                    sc[t + 1] = x.y;
                    sc[t + 2] = x.z;
                    sc[t + 3] = x.w;
                }
            }
#pragma unroll 4
            for (int rk = 1; rk < nc; ++rk) {
                const float* pr =
                    cl.map_shared_rank(part, rk) + sr * PS + 16 * sq;
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
            // the online softmax of row sr over its four lanes (a row's
            // four lanes are one quad of a warp, all in or all out)
            const unsigned quad = 0xfu << (lane & ~3);
            const float m_prev = m_sh[sr];
            mx = fmaxf(mx, __shfl_xor_sync(quad, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(quad, mx, 2));
            const float m_new = fmaxf(m_prev, mx);
            float sum = 0.f;
            float* pp = part + sr * PS + 16 * sq;       // over the partials
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
            sum += __shfl_xor_sync(quad, sum, 1);
            sum += __shfl_xor_sync(quad, sum, 2);
            if (sq == 0) {
                const float alpha = expf(m_prev - m_new);
                l_sh[sr] = l_sh[sr] * alpha + sum;
                m_sh[sr] = m_new;
                part[sr * PS + BK] = alpha;
            }
        }
        // barrier B: every row's P and alpha are written by its owner
        const float* pm = part;
        if (nc > 1) {
            cluster_arrive();
            cluster_wait();
            if (!owns) continue;
            // the 64 rows (probabilities and alpha) from their owners
            float* loc = ps_sh + (buf ^ 1) * FA_R * PS;
            for (int e = tid; e < FA_R * (BK / 4 + 1); e += FA_THREADS) {
                const int r = e / (BK / 4 + 1), c = 4 * (e % (BK / 4 + 1));
                *reinterpret_cast<float4*>(loc + r * PS + c) =
                    *reinterpret_cast<const float4*>(
                        cl.map_shared_rank(part, r / rpb) + r * PS + c);
            }
            pm = loc;
        }
        __syncthreads();                // P, alpha and V are in place
        if (!owns) continue;
        // O = O * alpha + P V
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float alpha = pm[(warp + 8 * i) * PS + BK];
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
    // each row's l from its owner; no block leaves while its l is read
    cl.sync();
    float den[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = warp + 8 * i;
        den[i] = fmaxf(*cl.map_shared_rank(l_sh + r, r / rpb), 1e-30f);
    }
    cl.sync();
    if (!owns) return;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = warp + 8 * i;
        if (r >= rows || r / g >= nq) continue;
        const int qi = q0 + r / g, h = hk * g + r % g;
        T* orow = o + (((size_t)b * Sq + qi) * Hq + h) * D;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int d = o0 + 4 * lane + j;
            if (d < D) fa_store(orow + d, acc[i][j] / den[i]);
        }
    }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                  int window, float cap, float scale, int vec,
                  cudaStream_t stream) {
    const int g = Hq / Hkv;
    const int tq = FA_R / g;
    const Split sp = split_d(D);
    auto kern = flash_f32_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err == cudaSuccess && sp.nc > 8)
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(sp.nc * B * Hkv), (Sq + tq - 1) / tq,
                       (unsigned)sp.ng);
    cfg.blockDim = dim3(FA_THREADS, 1, 1);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)sp.nc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)k,
                             (const T*)v, (T*)o, Sq, Skv, Hq, Hkv, D, g, tq,
                             causal, window, cap, scale, vec);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <typename T>
static int occupancy() {
    auto kern = flash_f32_kernel<T>;
    int blocks = -1;
    if (cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &blocks, kern, FA_THREADS, SMEM_BYTES) != cudaSuccess)
        return -1;
    return blocks;
}

}  // namespace fw

// f32 (bf16 == 0) or bf16 q, k, v, o, contiguous; window <= 0: none;
// cap <= 0: none.  The wrapper has checked D >= 1, Hq % Hkv == 0 and
// Hq / Hkv <= FA_R.
extern "C" int flash_attention_cuda_cores_launch(
        const void* q, const void* k, const void* v, void* o, int B, int Sq,
        int Skv, int Hq, int Hkv, int D, int causal, int window, float cap,
        float scale, int bf16, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    // one aligned vector load per 4 elements: D % 4 == 0 and aligned bases
    const size_t al = bf16 ? 8 : 16;
    const int vec = D % 4 == 0 && (size_t)q % al == 0 && (size_t)k % al == 0
                    && (size_t)v % al == 0;
    if (bf16)
        return fw::launch<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                         causal, window, cap, scale, vec, s);
    return fw::launch<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D, causal,
                             window, cap, scale, vec, s);
}

// Blocks an SM of the f32-arithmetic form (bf16 or f32 inputs), for
// chip_smoke.py's ptxas line; -1 when the query fails.
extern "C" int flash_attention_cuda_cores_occupancy(int bf16) {
    return bf16 ? fw::occupancy<__nv_bfloat16>() : fw::occupancy<float>();
}
