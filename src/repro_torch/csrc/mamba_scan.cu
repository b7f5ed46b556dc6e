// K10: Mamba-1 selective scan forward.  delta and u (B, S, C) f32, A (C, N),
// B and C rows (B, S, N), h0 (B, C, N) -> y (B, S, C), hT (B, C, N), all
// f32:  h_t = exp(delta_t A) h_{t-1} + (delta_t u_t) B_t,
//       y_t = sum_n h_t C_t.
//
// Replaces src/repro/kernels/mamba_scan.py:mamba_scan_pallas
// (_mamba_scan_kernel).  Bound on this card: bytes -- the kernel's inputs
// and outputs once, B S (2C + 2N) 4 + B S C 4 (+ A, h0, hT): ~0.8 GB at
// falcon-mamba-7b's B = 4, S = 2048, C = 8192, N = 16, ~0.24 ms, against
// ~7 FP32 operations per (b, t, c, n), ~0.11 ms.  Design: one thread per
// (batch row, channel) keeps h[N] and A[c, :] in registers for the whole
// sequence -- the Hopper analogue of the Pallas kernel's VMEM carry across
// its sequential sequence-grid axis.  Blocks tile the channels of one
// batch row; each chunk of MS_TS time steps stages that row's B and C
// rows (shared by every channel) and the block's delta and u columns
// (read coalesced across channels, all loads of the chunk in flight
// together) in shared memory.  y is written every step (coalesced across
// channels), hT at the end.  Ragged S and C are bounds checks.  N up to
// 64 (registers); the wrapper refuses more.
//
// The state update is unfused in the plain version's order,
// (exp(d A) * h) + ((d * u) * B), and the N-sum runs n = 0 .. N-1 as
// acc + h_n C_n, as the plain version (kernels/ref.py:mamba_scan_ref)
// sums it, so the two agree bit for bit where their expf agree.
#include "common.cuh"

#define MS_TC 128          // channels per block (one thread each)
#define MS_TS 16           // time steps per staged chunk

template <int NMAX>
__global__ void __launch_bounds__(MS_TC)
mamba_scan_kernel(const float* __restrict__ delta, const float* __restrict__ u,
                  const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ Cm, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ hT, int S, int C,
                  int N) {
    __shared__ float d_sh[MS_TS][MS_TC];
    __shared__ float u_sh[MS_TS][MS_TC];
    __shared__ float b_sh[MS_TS][NMAX];
    __shared__ float c_sh[MS_TS][NMAX];
    const int tid = threadIdx.x;
    const int b = blockIdx.y;
    const int c = blockIdx.x * MS_TC + tid;
    const bool live = c < C;
    float a[NMAX], h[NMAX];
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
        const bool in = live && n < N;
        a[n] = in ? A[(size_t)c * N + n] : 0.f;
        h[n] = in ? h0[((size_t)b * C + c) * N + n] : 0.f;
    }
    for (int t0 = 0; t0 < S; t0 += MS_TS) {
        const int nt = min(MS_TS, S - t0);
        __syncthreads();                // the last chunk has been read
        for (int t = 0; t < nt; ++t) {
            const size_t off = ((size_t)b * S + t0 + t) * C + c;
            d_sh[t][tid] = live ? delta[off] : 0.f;
            u_sh[t][tid] = live ? u[off] : 0.f;
        }
        for (int e = tid; e < nt * N; e += MS_TC) {
            const int t = e / N, n = e % N;
            const size_t off = ((size_t)b * S + t0 + t) * N + n;
            b_sh[t][n] = Bm[off];
            c_sh[t][n] = Cm[off];
        }
        __syncthreads();
        for (int t = 0; t < nt; ++t) {
            const float dt = d_sh[t][tid];
            const float du = __fmul_rn(dt, u_sh[t][tid]);
            float acc = 0.f;
#pragma unroll
            for (int n = 0; n < NMAX; ++n) {
                if (n < N) {
                    const float an = expf(__fmul_rn(dt, a[n]));
                    h[n] = __fadd_rn(__fmul_rn(an, h[n]),
                                     __fmul_rn(du, b_sh[t][n]));
                    acc = __fadd_rn(acc, __fmul_rn(h[n], c_sh[t][n]));
                }
            }
            if (live) y[((size_t)b * S + t0 + t) * C + c] = acc;
        }
    }
    if (!live) return;
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
        if (n < N) hT[((size_t)b * C + c) * N + n] = h[n];
}

template <int NMAX>
static int mamba_launch_t(const float* delta, const float* u, const float* A,
                          const float* Bm, const float* Cm, const float* h0,
                          float* y, float* hT, int B, int S, int C, int N,
                          cudaStream_t stream) {
    dim3 grid((C + MS_TC - 1) / MS_TC, B);
    mamba_scan_kernel<NMAX><<<grid, MS_TC, 0, stream>>>(delta, u, A, Bm, Cm,
                                                        h0, y, hT, S, C, N);
    return (int)cudaGetLastError();
}

// The wrapper (kernels/mamba_scan.py) has checked 1 <= N <= 64.
extern "C" int mamba_scan_launch(const float* delta, const float* u,
                                 const float* A, const float* Bm,
                                 const float* Cm, const float* h0, float* y,
                                 float* hT, int B, int S, int C, int N,
                                 void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (N <= 16)
        return mamba_launch_t<16>(delta, u, A, Bm, Cm, h0, y, hT, B, S, C,
                                  N, s);
    if (N <= 32)
        return mamba_launch_t<32>(delta, u, A, Bm, Cm, h0, y, hT, B, S, C,
                                  N, s);
    return mamba_launch_t<64>(delta, u, A, Bm, Cm, h0, y, hT, B, S, C, N,
                              s);
}
