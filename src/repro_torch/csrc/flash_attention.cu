// K9: fused attention forward with online softmax (GQA, causal, sliding
// window, score soft-cap).  q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D),
// float32 or bfloat16 -> o (B, Sq, Hq, D) in q's type.  Positions are
// implicit: query row i attends key rows <= i (causal) and > i - window.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_fwd_kernel).  Bound on this card: operations -- 4 D per
// unmasked (query head, key) pair, against q, k, v and o read or written
// once (at gemma2-2b's B = 2, S = 8192, Hq = 8, Hkv = 4, D = 256 a global
// layer is ~0.55 TFLOP against ~0.2 GB).  Design, simple first: one block
// per (batch x kv head, query tile); the g query heads of the kv head
// share the K/V tiles, folded into the block's FA_R rows as the Pallas
// kernel folds them into its tile rows (row r = query q0 + r / g, head
// hk g + r % g).  The scaled query rows stay in shared memory in f32; the
// block walks the key tiles of FA_TK rows (staged in shared memory in
// f32) with the online-softmax state (m, l) per row in shared memory and
// acc in registers, all f32, on CUDA cores.  Key tiles wholly outside the
// causal wedge or the window are never loaded.  Ragged Sq and Skv are
// bounds checks; nothing is padded in device memory.
//
// Semantics of the reference kept exactly: q scaled by D**-0.5 in f32
// before the product; cap * tanh(s / cap) before the mask; masked scores
// take the finite -2.3819763e38 (so a row's first all-masked tile is
// wiped by the first real score's alpha = 0, as in the reference); l is
// floored at 1e-30 in the final divide.  The D-sum and the key-sum run
// in another order than the plain version's, so the two agree to a
// tolerance, not bit for bit.
#include "common.cuh"

#include <cuda_bf16.h>

#define FA_R 64            // folded (query, head) rows per block
#define FA_TK 32           // key rows per tile
#define FA_THREADS 256
#define FA_NEG (-2.3819763e38f)

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void fa_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
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

// dtype: 0 float32, 1 bfloat16.  window <= 0: none; cap <= 0: none.  The
// wrapper (kernels/flash_attention.py) has checked D <= 256, Hq % Hkv == 0
// and Hq / Hkv <= FA_R.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Sq, int Skv, int Hq,
                                      int Hkv, int D, int causal, int window,
                                      float cap, float scale, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return flash_launch_d<float>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                     causal, window, cap, scale, s);
    return flash_launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, D,
                                         causal, window, cap, scale, s);
}
