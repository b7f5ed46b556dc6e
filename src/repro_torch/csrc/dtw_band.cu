// K4: banded DTW with row-block abandon against a per-pair cutoff,
// (P, L) x (P, L) -> (P,).  K6 is the same function with the per-step
// abandon form (PER_STEP).  Three forms; kernels/dtw_band.py:k4_form picks
// from (L, w) alone between the first two:
//
// - "warp" (2 wb + 1 <= 512, wb <= 255; the search paths' w = 51): one
//   warp per pair, the band state in registers, warp shuffles for the
//   neighbours, no block barrier (dtw_band_warp_kernel below);
// - "slots" (255 < wb <= 14463; the paper's large windows): the warp
//   form's slots over G warps a pair, the band state in registers, the
//   slots at warp edges through shared memory, one __syncthreads a step
//   when G > 1 (dtw_band_slots_kernel below);
// - "block" (forced only, the slots form's baseline): one block per pair,
//   the two band buffers in shared memory, a __syncthreads per
//   anti-diagonal (the kernel body in csrc/dtw_band.cuh, shared with K5's
//   scratch form).
//
// K4 replaces src/repro/kernels/dtw_band.py:dtw_band_pallas
// (_dtw_band_kernel_blocked, operand packing _pack_band_operands).  A dead
// pair's warp (block) exits -- the GPU form of "a tile whose lanes are all
// dead skips its remaining blocks", at a granularity of one pair.  The
// series are read straight from device memory (they stay in L1), which is
// what the Pallas kernel's host-side 2x-duplicated packing did in VMEM.
//
// K6 replaces src/repro/kernels/dtw_band.py:_dtw_band_kernel (the
// early_exit=False sweep), the baseline K4's skipping is measured against.
// Its plain version is core.dtw.dtw_band_blocked(..., row_block=1).
//
// Bound on this card: against 8 L bytes per pair, 5 FP32 operations per
// band cell (a subtract, a multiply, two mins, an add) over
// L(2w+1) - w(w+1) cells per pair for K4, 6 for K6 (one more min per cell
// into the frontier it tests every anti-diagonal): operation-bound.
#include "dtw_band.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

// ---- the warp form ------------------------------------------------------
//
// Lane l owns the M consecutive band slots k in [l M, l M + M) (M even,
// 32 M >= 2 wb + 1) in registers.  Slot k keeps the newest value of its
// diagonal line: a line k holds cells only on anti-diagonals d with
// d + k - wb even, so at step d the slots of d's parity hold S_{d-2} and
// the others S_{d-1}, and one array of M floats per lane is the whole
// state (as K5's cluster form shares one buffer).  Since M is even, the
// slots a lane updates at step d are the local slots m of one parity; the
// d loop is unrolled by two so that parity, and every register index, is a
// compile-time constant.
//
// The step of parity PAR updates local slots m = PAR, PAR + 2, ...:
//   S_d[k] = cost(i, j) + min(S_{d-1}[k-1], S_{d-1}[k+1], S_{d-2}[k]),
// with both neighbours of opposite parity (not written by this step).
// Inside the lane they are registers; the one outside is slot l M - 1 of
// lane l - 1 (PAR 0, __shfl_up_sync) or slot l M + M of lane l + 1 (PAR 1,
// __shfl_down_sync): one shuffle a step.  Slot wb starts at 0, the S_{-2}
// of the path's origin, so the first cell is cost + 0 with no special
// case.  a[i] and b[j] are read with __ldg (a pair's 8 L bytes stay in
// L1) at fixed offsets from two pointers that advance once a step pair.
//
// Cells: in the matrix's corners (an "edge" step, d < wb or
// d >= last - wb) the cells are the slots in [k_lo(d), k_hi(d)]; the
// others are not written and keep the +inf of the initialisation until
// their line starts (dtw_band.cuh says why that is exact).  Between the
// corners every slot k <= 2 wb of the step's parity is a cell, so the
// step tests only that (a per-lane constant).
//
// Abandon: the frontier is min over the valid cells of S_d and S_{d-1}.
// Between the corners (wb <= d <= last - wb) every slot of both parities
// is such a cell, so a check takes the minimum of the lane's slots; an
// edge step keeps the minimum of the cells it wrote instead (its slots
// may hold cells of older anti-diagonals).  The warp minimum comes from
// __shfl_xor_sync (fminf is exact, so the order changes no bit).  K4
// checks at the row_block_policy boundaries, (d + 1) % R == 0 or
// d == D - 1, and a dead pair (minimum strictly above the cutoff) writes
// +inf and its warp exits; a -inf cutoff returns +inf at once.  K6 checks
// every anti-diagonal, poisons the state to +inf and sweeps on.  Every
// branch on d or on a check is warp-uniform, so the full-mask shuffles
// always meet all 32 lanes.  The cell update is unfused (__fsub_rn,
// __fmul_rn, __fadd_rn): bit-equal to the plain version.
//
// Blocks hold K4_WARP_WARPS warps only for scheduling; nothing is shared
// and no barrier is taken.
#define K4_WARP_WARPS 4
#define K4_FULL 0xffffffffu

// One anti-diagonal d of parity PAR (d + PAR - wb even).  pa and pb point
// at a[i0] and b[j0], i0 = (d - PAR + l M - wb) / 2 and
// j0 = (d - PAR - l M + wb) / 2: cell t (slot m = PAR + 2 t) is
// (i0 + PAR + t, j0 - t).  lim = 2 wb - l M.  An EDGE step returns the
// minimum of the cells it wrote (+inf if none); the others return +inf.
template <int M, int PAR, bool EDGE>
__device__ __forceinline__ float warp_band_step(float (&s)[M], int d,
                                                int lane, int wb, int last,
                                                int lim,
                                                const float* __restrict__ pa,
                                                const float* __restrict__ pb) {
    float nb;
    if (PAR == 0) {
        nb = __shfl_up_sync(K4_FULL, s[M - 1], 1);      // S_{d-1}[l M - 1]
        if (lane == 0) nb = RT_INF;
    } else {
        nb = __shfl_down_sync(K4_FULL, s[0], 1);        // S_{d-1}[l M + M]
        if (lane == 31) nb = RT_INF;
    }
    int lo = 0, hi = lim;               // the cells' local slots
    if (EDGE) {
        lo = max(0, max(wb - d, d + wb - last)) - lane * M;
        hi = min(lim, min(d + wb, last - d + wb) - lane * M);
    }
    float f = RT_INF;
#pragma unroll
    for (int t = 0; t < M / 2; ++t) {
        const int m = PAR + 2 * t;
        if ((!EDGE || m >= lo) && m <= hi) {
            const float l = m == 0 ? nb : s[m > 0 ? m - 1 : 0];
            const float r = m == M - 1 ? nb : s[m < M - 1 ? m + 1 : 0];
            const float best = fminf(fminf(l, r), s[m]);
            const float diff = __fsub_rn(__ldg(pa + PAR + t), __ldg(pb - t));
            const float nd = __fadd_rn(__fmul_rn(diff, diff), best);
            s[m] = nd;
            if (EDGE) f = fminf(f, nd);
        }
    }
    return f;
}

__device__ __forceinline__ float warp_min(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fminf(v, __shfl_xor_sync(K4_FULL, v, o));
    return v;
}

template <int M, bool PER_STEP>
__global__ void __launch_bounds__(32 * K4_WARP_WARPS)
dtw_band_warp_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ cutoff,
                     float* __restrict__ out, long long P, int L, int wb,
                     int R) {
    const int lane = threadIdx.x & 31;
    const long long p =
        (long long)blockIdx.x * K4_WARP_WARPS + (threadIdx.x >> 5);
    if (p >= P) return;                 // the whole warp
    const float cut = cutoff[p];
    if (!PER_STEP && cut == -RT_INF) {
        if (lane == 0) out[p] = RT_INF;
        return;
    }
    const int D = 2 * L - 1;
    const int last = 2 * L - 2;
    const int base = lane * M;
    const int lim = 2 * wb - base;
    float s[M];
#pragma unroll
    for (int m = 0; m < M; ++m) s[m] = base + m == wb ? 0.f : RT_INF;
    // d runs in pairs (even slots, odd slots) from d0; d = -1 is no step
    const int d0 = -(wb & 1);
    const float* pa = a + (size_t)p * L + ((d0 + base - wb) >> 1);
    const float* pb = b + (size_t)p * L + ((d0 - base + wb) >> 1);
    float f0 = RT_INF, f1 = RT_INF;     // the last even / odd edge step's
    int check_at = min(R - 1, D - 1);   // K4's next row-block check
    // after step e: true when the pair is dead (K4 only; K6 poisons)
    auto dead_after = [&](int e) -> bool {
        if (!PER_STEP) {
            if (e != check_at) return false;
            check_at = min(check_at + R, D - 1);
        }
        float v = fminf(f0, f1);
        if (e >= wb && e <= last - wb) {
            v = s[0];
#pragma unroll
            for (int m = 1; m < M; ++m) v = fminf(v, s[m]);
        }
        if (warp_min(v) > cut) {
            if (!PER_STEP) return true;
#pragma unroll
            for (int m = 0; m < M; ++m) s[m] = RT_INF;
            f0 = f1 = RT_INF;
        }
        return false;
    };
    for (int d = d0; d < D; d += 2, ++pa, ++pb) {
        if (d >= 0) {
            if (d < wb || d >= last - wb)
                f0 = warp_band_step<M, 0, true>(s, d, lane, wb, last, lim,
                                                pa, pb);
            else
                warp_band_step<M, 0, false>(s, d, lane, wb, last, lim, pa,
                                            pb);
            if (dead_after(d)) {
                if (lane == 0) out[p] = RT_INF;
                return;
            }
        }
        const int e = d + 1;
        if (e < D) {
            if (e < wb || e >= last - wb)
                f1 = warp_band_step<M, 1, true>(s, e, lane, wb, last, lim,
                                                pa, pb);
            else
                warp_band_step<M, 1, false>(s, e, lane, wb, last, lim, pa,
                                            pb);
            if (dead_after(e)) {
                if (lane == 0) out[p] = RT_INF;
                return;
            }
        }
    }
    float v = RT_INF;
#pragma unroll
    for (int m = 0; m < M; ++m)
        if (base + m == wb) v = s[m];
    if (lane == wb / M) out[p] = v;
}

template <int M, bool PER_STEP>
static int warp_launch_m(const float* a, const float* b, const float* cutoff,
                         float* out, int P, int L, int wb, int R,
                         cudaStream_t stream) {
    const int blocks = (P + K4_WARP_WARPS - 1) / K4_WARP_WARPS;
    dtw_band_warp_kernel<M, PER_STEP>
        <<<blocks, 32 * K4_WARP_WARPS, 0, stream>>>(a, b, cutoff, out, P, L,
                                                    wb, R);
    return (int)cudaGetLastError();
}

// M: the fewest even slots a lane that cover the 2 wb + 1 slots in 32
// lanes.  kernels/dtw_band.py:k4_form sends only wb <= 255 here.
template <bool PER_STEP>
static int warp_launch(const float* a, const float* b, const float* cutoff,
                       float* out, int P, int L, int wb, int R,
                       void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int slots = 2 * wb + 1;
    if (slots <= 64)
        return warp_launch_m<2, PER_STEP>(a, b, cutoff, out, P, L, wb, R, s);
    if (slots <= 128)
        return warp_launch_m<4, PER_STEP>(a, b, cutoff, out, P, L, wb, R, s);
    if (slots <= 256)
        return warp_launch_m<8, PER_STEP>(a, b, cutoff, out, P, L, wb, R, s);
    if (slots <= 512)
        return warp_launch_m<16, PER_STEP>(a, b, cutoff, out, P, L, wb, R,
                                           s);
    return (int)cudaErrorInvalidValue;
}

// ---- the slots form -----------------------------------------------------
//
// The warp form's schedule over G = ceil((2 wb + 1) / (32 M)) warps a
// pair, for 255 < wb <= 14463: lane lam = 32 w + lane of the pair's warp
// w holds slots [lam M, lam M + M) in registers, so one step computes M / 2
// cells a lane with no shared-memory traffic for the band.  The neighbour
// inside a warp is a shuffle, as in the warp form; across warps, lane 0 of
// warp w publishes its slot 0 after each even step (el) and lane 31 its
// slot M - 1 after each odd step (er), and the neighbour warps read them
// at the start of the next step.  A slot written on one parity is read on
// the other, so a value is published on the step that writes it, read on
// the next, and the barrier of that next step orders the read before the
// value's next write: one barrier a step when G > 1, none when G == 1 (a
// warp a pair, four pairs a block, like the warp form).
//
// Geometry (kernels/dtw_band.py:k4_slots): G == 1 while 32 lanes of
// M <= 32 slots hold the band (wb <= 511), with the fewest even M >= 22
// (at fewer slots a lane ptxas spilled this kernel, at the warp form's 4
// and 16 too, so the warp form keeps wb <= 255); past that M = 32 in G <= 16 warps,
// one block a pair (wb <= 8191), then in a thread-block cluster of CL = 2
// blocks of ceil(G / 2) warps (wb <= 16383; the K4/K5 crossover stops it at
// 14463), the edges and check minima of the other block read through
// distributed shared memory and the barrier a cluster barrier.  107
// registers a thread at M = 32 leave no room for 1024 threads in a block.
//
// Each lane's M / 2 cells of a step pair read a[i0 .. i0 + M / 2] and
// b[j0 - M / 2 + 1 .. j0], and the next pair the same windows moved by one;
// they are kept in registers (av, bv) and moved by one a step pair, each
// with one load: the warp form's two loads a cell, strided by M / 2 floats
// across the warp, would cost M / 2 L1 wavefronts each.
//
// Checks: the warp minimum of the lanes' frontier values (as in the warp
// form), then, with G > 1, the minimum of the G warp minima through shared
// memory after one more barrier, so every warp of the pair takes the same
// decision.  K4 checks at the row_block_policy boundaries and a dead
// pair's block (warp, cluster) returns; K6 checks every step and poisons
// before the step publishes its edges.  The cell update is unfused.
#define K4S_BLOCK_WARPS 16
#define K4S_PAIRS_PER_WARP_BLOCK 4

template <int M, int PAR, bool EDGE>
__device__ __forceinline__ float slots_step(float (&s)[M], float nb, int d,
                                            int base, int wb, int last,
                                            int lim,
                                            const float (&av)[M / 2 + 1],
                                            const float (&bv)[M / 2]) {
    int lo = 0, hi = lim;               // the cells' local slots
    if (EDGE) {
        lo = max(0, max(wb - d, d + wb - last)) - base;
        hi = min(lim, min(d + wb, last - d + wb) - base);
    }
    float f = RT_INF;
#pragma unroll
    for (int t = 0; t < M / 2; ++t) {
        const int m = PAR + 2 * t;
        if ((!EDGE || m >= lo) && m <= hi) {
            const float l = m == 0 ? nb : s[m > 0 ? m - 1 : 0];
            const float r = m == M - 1 ? nb : s[m < M - 1 ? m + 1 : 0];
            const float best = fminf(fminf(l, r), s[m]);
            const float diff = __fsub_rn(av[PAR + t], bv[t]);
            const float nd = __fadd_rn(__fmul_rn(diff, diff), best);
            s[m] = nd;
            if (EDGE) f = fminf(f, nd);
        }
    }
    return f;
}

__device__ __forceinline__ float load_or_zero(const float* __restrict__ p,
                                              int i, int L) {
    return i >= 0 && i < L ? __ldg(p + i) : 0.f;
}

// The pair's shared words: warp q's entry of arr, in the block of the
// cluster that holds warp q (CL == 1: this block).
template <int CL>
__device__ __forceinline__ float pair_word(float* arr, int q, int wpb) {
    if constexpr (CL == 1)
        return arr[q];
    else
        return *cg::this_cluster().map_shared_rank(arr + q % wpb, q / wpb);
}

template <int CL>
__device__ __forceinline__ void pair_sync() {
    if constexpr (CL == 1)
        __syncthreads();
    else
        cg::this_cluster().sync();
}

template <int M, bool PER_STEP, int CL>
__global__ void __launch_bounds__(32 * K4S_BLOCK_WARPS)
dtw_band_slots_kernel(const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ cutoff,
                      float* __restrict__ out, long long P, int L, int wb,
                      int R, int G) {
    constexpr int H = M / 2;
    __shared__ float el[K4S_BLOCK_WARPS];   // warp w's slot 0 (lane 0)
    __shared__ float er[K4S_BLOCK_WARPS];   // warp w's slot M - 1 (lane 31)
    __shared__ float red[K4S_BLOCK_WARPS];  // warp minima at a check
    const int lane = threadIdx.x & 31;
    const int wi = threadIdx.x >> 5;
    const int wpb = blockDim.x >> 5;    // warps a block
    long long p;
    int w;                              // the warp within its pair
    if (G == 1) {
        p = (long long)blockIdx.x * wpb + wi;
        w = 0;
    } else {
        int rank = 0;
        if constexpr (CL > 1) rank = (int)cg::this_cluster().block_rank();
        p = blockIdx.x / CL;
        w = rank * wpb + wi;
    }
    if (p >= P) return;                 // whole pairs (G > 1: never)
    const float cut = cutoff[p];
    if (!PER_STEP && cut == -RT_INF) {
        if (w == 0 && lane == 0) out[p] = RT_INF;
        return;
    }
    const int D = 2 * L - 1;
    const int last = 2 * L - 2;
    const int base = (32 * w + lane) * M;
    const int lim = 2 * wb - base;
    float s[M];
#pragma unroll
    for (int m = 0; m < M; ++m) s[m] = base + m == wb ? 0.f : RT_INF;
    if (G > 1) {
        if (lane == 0) el[wi] = s[0];
        if (lane == 31) er[wi] = s[M - 1];
        pair_sync<CL>();
    }
    const int d0 = -(wb & 1);
    int i0 = (d0 + base - wb) >> 1;     // a[i0 + t], b[j0 - t] this pair
    int j0 = (d0 - base + wb) >> 1;
    const float* ap = a + (size_t)p * L;
    const float* bp = b + (size_t)p * L;
    float av[H + 1], bv[H];
#pragma unroll
    for (int t = 0; t <= H; ++t) av[t] = load_or_zero(ap, i0 + t, L);
#pragma unroll
    for (int t = 0; t < H; ++t) bv[t] = load_or_zero(bp, j0 - t, L);
    float f0 = RT_INF, f1 = RT_INF;     // the last even / odd edge step's
    int check_at = min(R - 1, D - 1);   // K4's next row-block check
    // after step e of parity par: the check (true when K4's pair is dead),
    // then the edges' publication and the step's barrier
    auto after = [&](int e, int par) -> bool {
        if (PER_STEP || e == check_at) {
            if (!PER_STEP) check_at = min(check_at + R, D - 1);
            float v = fminf(f0, f1);
            if (e >= wb && e <= last - wb) {
                v = s[0];
#pragma unroll
                for (int m = 1; m < M; ++m) v = fminf(v, s[m]);
            }
            v = warp_min(v);
            if (G > 1) {
                if (lane == 0) red[wi] = v;
                pair_sync<CL>();
                v = RT_INF;
                for (int q = 0; q < G; ++q)
                    v = fminf(v, pair_word<CL>(red, q, wpb));
            }
            if (v > cut) {
                if (!PER_STEP) {
                    // the other block may still read this one's minima
                    if (CL > 1) pair_sync<CL>();
                    return true;
                }
#pragma unroll
                for (int m = 0; m < M; ++m) s[m] = RT_INF;
                f0 = f1 = RT_INF;
            }
        }
        if (G > 1) {
            if (par == 0 && lane == 0) el[wi] = s[0];
            if (par == 1 && lane == 31) er[wi] = s[M - 1];
            pair_sync<CL>();
        }
        return false;
    };
    for (int d = d0; d < D; d += 2) {
        // the windows' next values
        const float na = load_or_zero(ap, i0 + 1 + H, L);
        const float nbv = load_or_zero(bp, j0 + 1, L);
        if (d >= 0) {
            float nb = __shfl_up_sync(K4_FULL, s[M - 1], 1);
            if (lane == 0)
                nb = w > 0 ? pair_word<CL>(er, w - 1, wpb) : RT_INF;
            if (d < wb || d >= last - wb)
                f0 = slots_step<M, 0, true>(s, nb, d, base, wb, last, lim,
                                            av, bv);
            else
                slots_step<M, 0, false>(s, nb, d, base, wb, last, lim, av,
                                        bv);
            if (after(d, 0)) {
                if (w == 0 && lane == 0) out[p] = RT_INF;
                return;
            }
        }
        const int e = d + 1;
        if (e < D) {
            float nb = __shfl_down_sync(K4_FULL, s[0], 1);
            if (lane == 31)
                nb = w < G - 1 ? pair_word<CL>(el, w + 1, wpb) : RT_INF;
            if (e < wb || e >= last - wb)
                f1 = slots_step<M, 1, true>(s, nb, e, base, wb, last, lim,
                                            av, bv);
            else
                slots_step<M, 1, false>(s, nb, e, base, wb, last, lim, av,
                                        bv);
            if (after(e, 1)) {
                if (w == 0 && lane == 0) out[p] = RT_INF;
                return;
            }
        }
        ++i0;
        ++j0;
#pragma unroll
        for (int t = 0; t < H; ++t) av[t] = av[t + 1];
        av[H] = na;
#pragma unroll
        for (int t = H - 1; t > 0; --t) bv[t] = bv[t - 1];
        bv[0] = nbv;
    }
    if (base <= wb && wb < base + M) {
        float v = RT_INF;
#pragma unroll
        for (int m = 0; m < M; ++m)
            if (base + m == wb) v = s[m];
        out[p] = v;
    }
}

// The slots form for band half-width wb and M slots a lane: G == 1 takes
// M in 22, 24, ..., 32 (four pairs a block); G > 1 takes M = 32, one block
// a pair up to 16 warps and a cluster of two blocks of ceil(G / 2) warps
// up to 32 (a last warp past the band holds +inf throughout).  Returns the
// launch error, cudaErrorInvalidValue for a geometry it does not take.
template <bool PER_STEP>
static int slots_launch(const float* a, const float* b, const float* cutoff,
                        float* out, int P, int L, int wb, int R, int M,
                        void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (M < 2 || M > 32 || (M & 1)) return (int)cudaErrorInvalidValue;
    const int G = (2 * wb + 1 + 32 * M - 1) / (32 * M);
    if (G == 1) {
        const int blocks = (P + K4S_PAIRS_PER_WARP_BLOCK - 1) /
                           K4S_PAIRS_PER_WARP_BLOCK;
        const int threads = 32 * K4S_PAIRS_PER_WARP_BLOCK;
        switch (M) {
#define K4S_ONE(m)                                                        \
    case m:                                                               \
        dtw_band_slots_kernel<m, PER_STEP, 1>                             \
            <<<blocks, threads, 0, st>>>(a, b, cutoff, out, P, L, wb, R, 1); \
        return (int)cudaGetLastError();
            K4S_ONE(22) K4S_ONE(24) K4S_ONE(26) K4S_ONE(28) K4S_ONE(30)
            K4S_ONE(32)
#undef K4S_ONE
            default:
                return (int)cudaErrorInvalidValue;
        }
    }
    if (M != 32 || G > 2 * K4S_BLOCK_WARPS) return (int)cudaErrorInvalidValue;
    if (G <= K4S_BLOCK_WARPS) {
        dtw_band_slots_kernel<32, PER_STEP, 1>
            <<<P, 32 * G, 0, st>>>(a, b, cutoff, out, P, L, wb, R, G);
        return (int)cudaGetLastError();
    }
    const int wpb = (G + 1) / 2;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(2 * P), 1, 1);
    cfg.blockDim = dim3(32 * wpb, 1, 1);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const long long PP = P;
    cudaError_t err = cudaLaunchKernelEx(
        &cfg, dtw_band_slots_kernel<32, PER_STEP, 2>, a, b, cutoff, out, PP,
        L, wb, R, 2 * wpb);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// ---- the block form -----------------------------------------------------
//
// The two band buffers take 2 (2 wb + 1) 4 bytes of dynamic shared
// memory.  kernels/dtw_band.py:dtw_band_route is the one place that
// decides whether they fit (past it the band runs in K5); a band too wide
// for the card fails here in cudaFuncSetAttribute.
template <bool PER_STEP>
static int block_launch(const float* a, const float* b, const float* cutoff,
                        float* out, int P, int L, int wb, int R,
                        void* stream) {
    const long long smem = 2LL * (2LL * wb + 1) * 4;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            dtw_band_kernel<PER_STEP, false>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dtw_band_kernel<PER_STEP, false>
        <<<P, dtw_band_threads(wb), (size_t)smem, (cudaStream_t)stream>>>(
            a, b, cutoff, out, nullptr, P, L, wb, R);
    return (int)cudaGetLastError();
}

extern "C" int dtw_band_launch(const float* a, const float* b,
                               const float* cutoff, float* out, int P,
                               int L, int wb, int R, void* stream) {
    return warp_launch<false>(a, b, cutoff, out, P, L, wb, R, stream);
}

extern "C" int dtw_band_step_launch(const float* a, const float* b,
                                    const float* cutoff, float* out, int P,
                                    int L, int wb, void* stream) {
    return warp_launch<true>(a, b, cutoff, out, P, L, wb, 1, stream);
}

extern "C" int dtw_band_slots_launch(const float* a, const float* b,
                                     const float* cutoff, float* out, int P,
                                     int L, int wb, int R, int M,
                                     void* stream) {
    return slots_launch<false>(a, b, cutoff, out, P, L, wb, R, M, stream);
}

extern "C" int dtw_band_step_slots_launch(const float* a, const float* b,
                                          const float* cutoff, float* out,
                                          int P, int L, int wb, int M,
                                          void* stream) {
    return slots_launch<true>(a, b, cutoff, out, P, L, wb, 1, M, stream);
}

extern "C" int dtw_band_block_launch(const float* a, const float* b,
                                     const float* cutoff, float* out, int P,
                                     int L, int wb, int R, void* stream) {
    return block_launch<false>(a, b, cutoff, out, P, L, wb, R, stream);
}

extern "C" int dtw_band_step_block_launch(const float* a, const float* b,
                                          const float* cutoff, float* out,
                                          int P, int L, int wb,
                                          void* stream) {
    return block_launch<true>(a, b, cutoff, out, P, L, wb, 1, stream);
}

template <int M>
static int warp_occupancy_m(int per_step) {
    int n = 0;
    const int threads = 32 * K4_WARP_WARPS;
    const cudaError_t e =
        per_step ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, dtw_band_warp_kernel<M, true>, threads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, dtw_band_warp_kernel<M, false>, threads, 0);
    return e == cudaSuccess ? n * K4_WARP_WARPS : -(int)e;
}

// Resident warps per SM of the warp form's kernel for band half-width wb,
// or minus a CUDA error: a reading for the measurement script, which no
// launch uses.
extern "C" int dtw_band_warp_occupancy(int wb, int per_step) {
    const int slots = 2 * wb + 1;
    if (slots <= 64) return warp_occupancy_m<2>(per_step);
    if (slots <= 128) return warp_occupancy_m<4>(per_step);
    if (slots <= 256) return warp_occupancy_m<8>(per_step);
    return warp_occupancy_m<16>(per_step);
}

// Resident warps per SM of the slots form's kernel for band half-width wb
// and M slots a lane, or minus a CUDA error (a reading for the
// measurement script, as dtw_band_warp_occupancy).
template <int M, int CL>
static int slots_occupancy_m(int threads, int per_step) {
    int n = 0;
    const cudaError_t e =
        per_step ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, dtw_band_slots_kernel<M, true, CL>, threads, 0)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &n, dtw_band_slots_kernel<M, false, CL>, threads, 0);
    return e == cudaSuccess ? n * threads / 32 : -(int)e;
}

extern "C" int dtw_band_slots_occupancy(int wb, int M, int per_step) {
    const int G = (2 * wb + 1 + 32 * M - 1) / (32 * M);
    if (G == 1) {
        const int t = 32 * K4S_PAIRS_PER_WARP_BLOCK;
        switch (M) {
#define K4S_OCC(m) \
    case m:        \
        return slots_occupancy_m<m, 1>(t, per_step);
            K4S_OCC(22) K4S_OCC(24) K4S_OCC(26) K4S_OCC(28) K4S_OCC(30)
            K4S_OCC(32)
#undef K4S_OCC
            default:
                return -(int)cudaErrorInvalidValue;
        }
    }
    if (M != 32 || G > 2 * K4S_BLOCK_WARPS) return -(int)cudaErrorInvalidValue;
    if (G <= K4S_BLOCK_WARPS)
        return slots_occupancy_m<32, 1>(32 * G, per_step);
    return slots_occupancy_m<32, 2>(32 * ((G + 1) / 2), per_step);
}

extern "C" const char* rt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
