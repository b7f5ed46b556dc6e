// K10: Mamba-1 selective scan forward.  delta and u (B, S, C) f32, A (C, N),
// B and C rows (B, S, N), h0 (B, C, N) -> y (B, S, C), hT (B, C, N), all
// f32:  h_t = exp(delta_t A) h_{t-1} + (delta_t u_t) B_t,
//       y_t = sum_n h_t C_t.
//
// Replaces src/repro/kernels/mamba_scan.py:mamba_scan_pallas
// (_mamba_scan_kernel).  Bound on this card: bytes -- the kernel's inputs
// and outputs once, B S (2C + 2N) 4 + B S C 4 (+ A, h0, hT): ~0.8 GB at
// falcon-mamba-7b's B = 4, S = 2048, C = 8192, N = 16, ~0.24 ms, against
// ~7 FP32 operations per (b, t, c, n), ~0.11 ms.  The B S C N expf calls
// also pass the SFU (16 a clock per SM), ~0.29 ms there: a floor the
// bound does not count.
//
// Design: states across lanes.  A (batch row, channel) pair is a group of
// G lanes (G = 2 at N = 16, so 16 channels a warp); lane k of the group
// holds the 8 consecutive states n in [8 k, 8 k + 8) and their A[c, n] in
// registers for the whole sequence -- the Hopper analogue of the Pallas
// kernel's VMEM carry across its sequential sequence-grid axis, spread so
// that B C G threads carry it instead of B C.  G = ceil(N / 8) rounded up
// to a power of two, at most 32: N <= 256.
//
// The N-sum keeps the plain version's order, n = 0 .. N-1 as
// acc + h_n C_n, each product and sum rounded on its own
// (kernels/ref.py:mamba_scan_ref), by passing the running sum down the
// group: lane k adds its 8 products to the sum lane k - 1 made of the
// states before its own.  The group is skewed by one step a lane -- at
// iteration s lane k runs step t = s - k -- so the sum of step t that lane
// k - 1 made at iteration s - 1 arrives by one __shfl_up_sync at iteration
// s, and every lane works at once; lane G - 1 writes y[t] (16 consecutive
// channels of a warp at N = 16: 64 bytes).  A step costs a lane one
// shuffle, against a shared-memory transpose's store and load per product.
//
// A block of MS_WARPS warps holds CHB = 32 MS_WARPS / G channels of one
// batch row.  Each chunk of T iterations needs the steps its lanes reach
// (T + G - 1, the skew's halo included) of the block's delta and u columns
// and of the row's B and C rows (shared by every channel): they are copied
// to shared memory by cp.async, the next chunk's while this one runs (two
// buffers), so no warp waits on device memory between chunks.  Lane k
// reads its step's delta and u (a row stride of G mod 32 words keeps the
// warp's 32 reads on 32 banks) and its 8 B and C values with 16-byte
// loads (G addresses a warp, broadcast).  The state update is unfused in
// the plain version's order, (exp(d A) * h) + ((d * u) * B), so the two
// agree bit for bit where their expf agree.  Ragged S and C are copies of
// 0 bytes (cp.async fills zeros); states past N see zero A, B and C, and
// add +0 to a sum that is never -0.
//
// The wide-state form (N > 256, launch count mamba_scan_wide) is the same
// kernel at G = 32 with one more loop outside the sequence: pass p runs
// the whole sequence for states [256 p, 256 p + 256), h and A of those
// states in the group's registers as above, and lane 0 starts each step's
// sum from y[t] as pass p - 1 left it (0 in pass 0) instead of from 0.
// Pass p - 1's sum of step t is the running sum over the states before
// 256 p, so the n-ordered sum, and with it bit-equality, holds for any N.
// y is staged like delta (rows of steps >= the chunk's first, which lane 31
// of this pass has not yet overwritten); a block barrier between passes
// makes the last pass's y writes visible to the next pass's copies.  hT
// takes each pass's states at its end.  The inputs are read N / 256
// times; the form is on no path (falcon-mamba-7b has N = 16).
#include "common.cuh"

#define MS_WARPS 8                 // warps per block
#define MS_NS 8                    // states a lane

template <int G, bool WIDE>
struct MsGeom {
    static constexpr int T = G == 32 ? 16 : 32;         // iterations a chunk
    static constexpr int CHB = 32 / G * MS_WARPS;       // channels a block
    static constexpr int TT = T + G - 1;                // staged steps
    static constexpr int DSTR = G == 32 ? 64 : 32 + G;  // >= TT, = G mod 32
    static constexpr int NP = G * MS_NS;                // states a group
    // one buffer: delta and u [CHB][DSTR], B and C [TT][NP], and in the
    // wide form the earlier passes' sums y [CHB][DSTR]
    static constexpr int BUF = (WIDE ? 3 : 2) * CHB * DSTR + 2 * TT * NP;
    static constexpr int BYTES = 2 * BUF * 4;
};

// 4 bytes global -> shared, asynchronously; !ok copies 0 bytes and fills
// the word with zeros
__device__ __forceinline__ void ms_copy(float* dst, const float* src,
                                        bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(ok ? 4 : 0));
}

template <int G, bool WIDE>
__global__ void __launch_bounds__(32 * MS_WARPS)
mamba_scan_kernel(const float* __restrict__ delta, const float* __restrict__ u,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ hT, int S,
                  int C, int N) {
    using Geo = MsGeom<G, WIDE>;
    constexpr int T = Geo::T, CHB = Geo::CHB, TT = Geo::TT;
    constexpr int DSTR = Geo::DSTR, NP = Geo::NP, NS = MS_NS;
    extern __shared__ float4 sm4[];
    float* sm = reinterpret_cast<float*>(sm4);
    const int tid = threadIdx.x;
    const int k = tid % G;                          // the lane's place
    const int cl = tid / G;                         // the group's channel
    const int b = blockIdx.y;
    const int c0 = blockIdx.x * CHB;
    const int c = c0 + cl;
    const bool live = c < C;
    const int iters = S + G - 1;
    // one pass over the sequence per NP states; the narrow forms have
    // N <= NP and a bound the compiler sees is one pass, so their code is
    // that of a kernel without this loop
    for (int nb = 0; nb < (WIDE ? N : 1); nb += NP) {
        const int n0 = nb + k * NS;
        // the steps [s0 - G + 1, s0 + T) of chunk s0 into buffer buf
        auto stage = [&](int s0, int buf) {
            const int tb = s0 - (G - 1);
            float* d_sh = sm + buf * Geo::BUF;
            float* u_sh = d_sh + CHB * DSTR;
            float* b_sh = u_sh + CHB * DSTR;
            float* c_sh = b_sh + TT * NP;
            float* y_sh = c_sh + TT * NP;
            for (int e = tid; e < TT * CHB; e += 32 * MS_WARPS) {
                const int ch = e % CHB, r = e / CHB, t = tb + r;
                const bool ok = t >= 0 && t < S && c0 + ch < C;
                const size_t off = ok ? ((size_t)b * S + t) * C + c0 + ch : 0;
                ms_copy(d_sh + ch * DSTR + r, delta + off, ok);
                ms_copy(u_sh + ch * DSTR + r, u + off, ok);
                // lane 0's rows (steps >= s0) of the earlier passes' sums
                if (WIDE)
                    ms_copy(y_sh + ch * DSTR + r, y + off,
                            ok && nb > 0 && r >= G - 1);
            }
            for (int e = tid; e < TT * NP; e += 32 * MS_WARPS) {
                const int n = e % NP, r = e / NP, t = tb + r;
                const bool ok = t >= 0 && t < S && nb + n < N;
                const size_t off = ok ? ((size_t)b * S + t) * N + nb + n : 0;
                ms_copy(b_sh + r * NP + n, Bm + off, ok);
                ms_copy(c_sh + r * NP + n, Cm + off, ok);
            }
            asm volatile("cp.async.commit_group;\n" ::);
        };
        float a[NS], h[NS];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const bool in = live && n0 + j < N;
            a[j] = in ? A[(size_t)c * N + n0 + j] : 0.f;
            h[j] = in ? h0[((size_t)b * C + c) * N + n0 + j] : 0.f;
        }
        float acc = 0.f;
        if (WIDE) __syncthreads();      // the last pass's y is written
        stage(0, 0);
        int buf = 0;
        for (int s0 = 0; s0 < iters; s0 += T, buf ^= 1) {
            __syncthreads();            // the other buffer's chunk is read
            if (s0 + T < iters)
                stage(s0 + T, buf ^ 1);
            else
                asm volatile("cp.async.commit_group;\n" ::);  // an empty group
            asm volatile("cp.async.wait_group 1;\n" ::);      // this chunk's
            __syncthreads();
            const float* d_sh = sm + buf * Geo::BUF;
            const float* u_sh = d_sh + CHB * DSTR;
            const float* b_sh = u_sh + CHB * DSTR;
            const float* c_sh = b_sh + TT * NP;
            const float* y_sh = c_sh + TT * NP;
            const int ns = min(T, iters - s0);
#pragma unroll 4
            for (int i = 0; i < ns; ++i) {
                // the sum of this lane's step from lane k - 1 (its last
                // iteration); lane 0 starts each step's sum at 0, or in the
                // wide form at the earlier passes' sum
                const float prev = __shfl_up_sync(0xffffffffu, acc, 1, G);
                acc = k == 0 ? (WIDE ? y_sh[cl * DSTR + i + G - 1] : 0.f)
                             : prev;
                const int t = s0 + i - k;
                if (t >= 0 && t < S) {
                    const int r = i + G - 1 - k;    // the tile row of step t
                    const float dt = d_sh[cl * DSTR + r];
                    const float du = __fmul_rn(dt, u_sh[cl * DSTR + r]);
                    const float* br = b_sh + r * NP + k * NS;
                    const float* cr = c_sh + r * NP + k * NS;
#pragma unroll
                    for (int j4 = 0; j4 < NS; j4 += 4) {
                        const float4 bv =
                            *reinterpret_cast<const float4*>(br + j4);
                        const float4 cv =
                            *reinterpret_cast<const float4*>(cr + j4);
                        const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
                        const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
                        for (int jj = 0; jj < 4; ++jj) {
                            const int j = j4 + jj;
                            const float an = expf(__fmul_rn(dt, a[j]));
                            h[j] = __fadd_rn(__fmul_rn(an, h[j]),
                                             __fmul_rn(du, bb[jj]));
                            acc = __fadd_rn(acc, __fmul_rn(h[j], cc[jj]));
                        }
                    }
                    if (k == G - 1 && live)
                        y[((size_t)b * S + t) * C + c] = acc;
                }
            }
        }
        asm volatile("cp.async.wait_group 0;\n" ::);
        if (live) {
#pragma unroll
            for (int j = 0; j < NS; ++j)
                if (n0 + j < N) hT[((size_t)b * C + c) * N + n0 + j] = h[j];
        }
    }
}

template <int G, bool WIDE>
static int mamba_set_smem() {
    return (int)cudaFuncSetAttribute(
        mamba_scan_kernel<G, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MsGeom<G, WIDE>::BYTES);
}

template <int G, bool WIDE = false>
static int mamba_launch_t(const float* delta, const float* u, const float* A,
                          const float* Bm, const float* Cm, const float* h0,
                          float* y, float* hT, int B, int S, int C, int N,
                          cudaStream_t stream) {
    using Geo = MsGeom<G, WIDE>;
    const int e = mamba_set_smem<G, WIDE>();
    if (e) return e;
    dim3 grid((C + Geo::CHB - 1) / Geo::CHB, B);
    mamba_scan_kernel<G, WIDE><<<grid, 32 * MS_WARPS, Geo::BYTES, stream>>>(
        delta, u, A, Bm, Cm, h0, y, hT, S, C, N);
    return (int)cudaGetLastError();
}

#define MS_DISPATCH(F, ...)                                                 \
    (N <= 8     ? F<1>(__VA_ARGS__)                                         \
     : N <= 16  ? F<2>(__VA_ARGS__)                                         \
     : N <= 32  ? F<4>(__VA_ARGS__)                                         \
     : N <= 64  ? F<8>(__VA_ARGS__)                                         \
     : N <= 128 ? F<16>(__VA_ARGS__)                                        \
                : F<32>(__VA_ARGS__))

// The wrapper (kernels/mamba_scan.py) has checked 1 <= N <= 256: groups
// of G = N / 8 lanes, rounded up to a power of two, at most 32.
extern "C" int mamba_scan_launch(const float* delta, const float* u,
                                 const float* A, const float* Bm,
                                 const float* Cm, const float* h0, float* y,
                                 float* hT, int B, int S, int C, int N,
                                 void* stream) {
    if (N < 1 || N > 256) return (int)cudaErrorInvalidValue;
    return MS_DISPATCH(mamba_launch_t, delta, u, A, Bm, Cm, h0, y, hT, B, S,
                       C, N, (cudaStream_t)stream);
}

// The wide-state form, N > 256 (the wrapper picks it by N): ceil(N / 256)
// passes of groups of 32 lanes in one launch.
extern "C" int mamba_scan_wide_launch(const float* delta, const float* u,
                                      const float* A, const float* Bm,
                                      const float* Cm, const float* h0,
                                      float* y, float* hT, int B, int S,
                                      int C, int N, void* stream) {
    if (N <= 256) return (int)cudaErrorInvalidValue;
    return mamba_launch_t<32, true>(delta, u, A, Bm, Cm, h0, y, hT, B, S, C,
                                    N, (cudaStream_t)stream);
}

template <int G, bool WIDE = false>
static int mamba_occupancy_t() {
    const int smem = MsGeom<G, WIDE>::BYTES;
    int n = 0;
    cudaError_t e = (cudaError_t)mamba_set_smem<G, WIDE>();
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, mamba_scan_kernel<G, WIDE>, 32 * MS_WARPS, smem);
    return e == cudaSuccess ? n * MS_WARPS : -(int)e;
}

// Resident warps per SM for N states (the wide form past 256), or minus a
// CUDA error: a reading for the measurement script, which no launch uses.
extern "C" int mamba_scan_occupancy(int N) {
    if (N < 1) return -(int)cudaErrorInvalidValue;
    if (N > 256) return mamba_occupancy_t<32, true>();
    return MS_DISPATCH(mamba_occupancy_t, );
}
