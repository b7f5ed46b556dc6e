// K4: banded DTW with row-block abandon against a per-pair cutoff,
// (P, L) x (P, L) -> (P,).  K6 is the same function with the per-step
// abandon form (PER_STEP).  Two forms, picked by
// kernels/dtw_band.py:k4_form from (L, w) alone:
//
// - "warp" (2 wb + 1 <= 512, wb <= 255; the search paths' w = 51): one
//   warp per pair, the band state in registers, warp shuffles for the
//   neighbours, no block barrier (dtw_band_warp_kernel below);
// - "block" (255 < wb <= 14463): one block per pair, the two band buffers
//   in shared memory, a __syncthreads per anti-diagonal (the kernel body
//   in csrc/dtw_band.cuh, shared with K5's scratch form).
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

extern "C" const char* rt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
