// K5: banded DTW with per-pair cutoffs for bands too wide for K4's two
// shared-memory buffers, (P, L) x (P, L) -> (P,)
// (kernels/dtw_band.py:dtw_band_route: wb > 14463), in three forms that
// kernels/dtw_band.py:k5_form picks from (L, w) alone:
//
//   (a) "rows"     L <= 20480: one block of 512 threads per pair, each
//                  thread K <= 40 consecutive rows in registers, K
//                  anti-diagonals a step (the long path's form);
//   (b) "cluster"  L > 20480 and wb <= 231423: the band state in one
//                  shared-memory buffer of 2wb + 1 slots cut into slices
//                  over a thread-block cluster of 2-8 blocks per pair
//                  (L = 65536 at w = L is 3 blocks);
//   (c) "scratch"  past that: a persistent grid with the band state
//                  in a device-memory scratch (csrc/dtw_band.cuh, STREAM).
//
// Replaces src/repro/kernels/dtw_band.py:_dtw_band_pallas_stream (body
// _dtw_band_kernel_stream), the TPU kernel that keeps the operands in HBM
// and double-buffers per-row-block windows into VMEM.  On the card the
// operands are read from device memory at any L (K4 does so too); what no
// longer fits K4's layout is the band state.
//
// Bound on this card: 5 FP32 operations per band cell, L(2w+1) - w(w+1)
// cells per pair, against 8 L bytes per pair: operation-bound.  Form (c)
// waits on its scratch (three dependent L2/HBM reads and a write per cell,
// 76 MB of scratch at L = 17984 against the 50 MB L2).  Form (b) keeps
// the state on chip but still spends, per cell, index arithmetic, three
// shared-memory reads, a write and two loads of a and b (which no longer
// fit L1 beside a 144 KB buffer), with a barrier per anti-diagonal;
// form (a) computes a cell with five arithmetic operations on registers
// (chip_smoke.py times both on the long path's largest round).
//
// Every form keeps the plain version's abandon rule, -inf-cutoff slots and
// unfused cell update (__fsub_rn, __fmul_rn, __fadd_rn), so each is
// bit-equal to kernels/ref.py:dtw_band_ref.
#include "dtw_band.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

// ---- form (b): the band in one buffer over a cluster ---------------------
// One buffer holds S_{d-1} and S_{d-2}.  A cell of anti-diagonal d lives
// at a slot k with d + k - wb even, so S_d uses the slots of one parity
// and S_{d-1} the other: S_d[k] reads S_{d-1}[k - 1], S_{d-1}[k + 1]
// (the other parity) and S_{d-2}[k] (its own slot), and overwrites that
// slot in place.  The slots are stored split by parity -- the even slots
// of a slice, then its odd slots -- so the threads of a warp, which take
// every second k, touch consecutive words (no bank conflicts).  Slot k of
// a slice starting at the even k0 has index (k - k0) / 2, plus half the
// slice for odd k.  A valid cell's predecessors are valid cells or lie
// before the start of their diagonal line, where the slot still holds
// the +inf of the initialisation, as in the two-buffer body of
// csrc/dtw_band.cuh.  Block r of the cluster holds slots [r S, r S + S):
// the two reads that cross a slice edge, S_{d-1}[k0 - 1] and
// S_{d-1}[k0 + S], go to the neighbour's shared memory (distributed
// shared memory, cooperative_groups::cluster_group::map_shared_rank).
// One cluster barrier per anti-diagonal orders the writes of S_d before
// every read of it and the reads of S_{d-1} before the writes of S_{d+1}.
// At the row-block boundaries the blocks' frontier minima are reduced
// across the cluster, so every block takes the same abandon decision.
//
// Floats of band state one block may hold: the 231,424 bytes of
// kernels/dtw_band.py:_RESIDENT_SMEM_BYTES, past the 132 static bytes.
#define K5_BLOCK_FLOATS 57856
#define K5_MAX_CLUSTER 8
// cells a thread updates at a time, all their reads before their writes,
// so their loads overlap
#define K5_ILP 4

__global__ void __launch_bounds__(1024)
dtw_band_cluster_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ cutoff,
                        float* __restrict__ out, int L, int wb, int R,
                        int S) {
    extern __shared__ float buf[];      // [S]: even slots, then odd slots
    __shared__ float red[32];
    __shared__ float cmin;              // this block's frontier minimum
    cg::cluster_group cl = cg::this_cluster();
    const int n = (int)cl.num_blocks(), rank = (int)cl.block_rank();
    const long long p = blockIdx.x / n;
    const float cut = cutoff[p];
    if (cut == -RT_INF) {               // an invalid slot: +inf at once
        if (threadIdx.x == 0 && rank == 0) out[p] = RT_INF;
        return;
    }
    const int H = S >> 1;
    const int k0 = rank * S;            // this block's slots [k0, k1)
    const int k1 = min(k0 + S, 2 * wb + 1);
    for (int e = threadIdx.x; e < S; e += blockDim.x) buf[e] = RT_INF;
    const float* lbuf = buf;            // the neighbours' slices
    const float* rbuf = buf;
    if (rank > 0) lbuf = cl.map_shared_rank(buf, rank - 1);
    if (rank < n - 1) rbuf = cl.map_shared_rank(buf, rank + 1);
    cl.sync();                          // every slice holds +inf
    const float* ap = a + (size_t)p * L;
    const float* bp = b + (size_t)p * L;
    const int D = 2 * L - 1;
    const int last = 2 * L - 2;
    float fprev = RT_INF;               // min of this thread's S_{d-1} cells
    bool dead = false;
    for (int d = 0; d < D; ++d) {
        // cells of anti-diagonal d: 2i = d + k - wb and 2j = d - k + wb
        // in [0, 2L - 2], 2i even; this block takes those in [k0, k1)
        int k_lo = max(0, max(wb - d, d + wb - last));
        const int k_hi = min(2 * wb, min(d + wb, last - d + wb));
        k_lo += (d + k_lo - wb) & 1;
        const int par = k_lo & 1;       // parity of S_d's slots
        int kb = max(k_lo, k0);
        kb += (kb - k_lo) & 1;
        const int ke = min(k_hi, k1 - 1);
        float* own = buf + par * H;     // S_d's (and S_{d-2}'s) slots
        const float* oth = buf + (par ^ 1) * H;     // S_{d-1}'s
        float fcur = RT_INF;
        // K5_ILP cells per thread at a time: all their reads (none of which
        // a write of this anti-diagonal can touch) before their writes
        const int step = 2 * (int)blockDim.x;
        for (int kc0 = kb + 2 * (int)threadIdx.x; kc0 <= ke;
             kc0 += K5_ILP * step) {
            float cost[K5_ILP], best[K5_ILP];
#pragma unroll
            for (int u = 0; u < K5_ILP; ++u) {
                const int k = min(kc0 + u * step, ke);  // past ke: not written
                const int m = (k - k0) >> 1;
                const int i = (d + k - wb) >> 1;
                const int j = (d - k + wb) >> 1;
                const float diff = __fsub_rn(__ldg(ap + i), __ldg(bp + j));
                cost[u] = __fmul_rn(diff, diff);
                if (d == 0) {
                    best[u] = 0.f;      // the path's origin, k == wb
                } else {
                    float l = RT_INF, r = RT_INF;
                    if (k > 0) l = k > k0 ? oth[m - 1 + par] : lbuf[S - 1];
                    if (k < 2 * wb)
                        r = k + 1 < k0 + S ? oth[m + par] : rbuf[0];
                    best[u] = fminf(fminf(l, r), own[m]);
                }
            }
#pragma unroll
            for (int u = 0; u < K5_ILP; ++u) {
                const int k = kc0 + u * step;
                if (k <= ke) {
                    const float nd = __fadd_rn(cost[u], best[u]);
                    own[(k - k0) >> 1] = nd;
                    fcur = fminf(fcur, nd);
                }
            }
        }
        cl.sync();
        if (((d + 1) % R == 0) || (d == D - 1)) {
            float fm = rt_block_min(fminf(fcur, fprev), red);
            if (threadIdx.x == 0) cmin = fm;
            cl.sync();
            fm = RT_INF;
            for (int q = 0; q < n; ++q)
                fm = fminf(fm, *cl.map_shared_rank(&cmin, q));
            cl.sync();                  // before cmin is written again
            if (fm > cut) {
                dead = true;
                break;
            }
        }
        fprev = fcur;
    }
    // S_{D-1}[wb], in the block whose slice holds slot wb
    if (threadIdx.x == 0 && wb >= k0 && wb < k1)
        out[p] = dead ? RT_INF : buf[((wb - k0) & 1) * H + ((wb - k0) >> 1)];
}

static int set_smem(const void* kern, long long smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---- form (a): rows in registers ----------------------------------------
// Thread g of the block owns the K consecutive rows r0 = g K .. r0 + K - 1
// (a[r] in registers) and at step tau computes column j = tau - g K of
// them, top to bottom: every thread works on anti-diagonals tau .. tau +
// K - 1, so the block sweeps the anti-diagonals in the plain version's
// order, K at a time.  Of a cell's three predecessors, D(r, j - 1) is the
// thread's own register from the step before, and D(r - 1, j),
// D(r - 1, j - 1) are its own cell just computed and the register it
// replaced -- except for the first row, which takes them from thread
// g - 1's last row, computed K and K + 1 steps before: a delay line of
// K + 1 steps in shared memory (one write and one read a thread and
// step), the older value kept from the step before in a register.  A
// virtual D(-1, -1) = 0 starts the path at (0, 0).  Cells outside the band
// or the matrix are +inf, as the band-packed slots of the plain version.
// A cell costs a subtract, a multiply, two mins and an add, all in
// registers; b[j] is read once per thread and step.
//
// The abandon rule stays the plain version's: boundary b (anti-diagonal
// d_b = min((b + 1) R - 1, D - 1)) tests the minimum over the cells of d_b
// and d_b - 1.  Threads fold those cells into fm (shared memory, float
// bits under atomicMin: every value is >= 0; a ring of K + 2 boundaries,
// more than are ever open at once) as they compute them, and the block
// decides boundary b after the step tau_b <= d_b that completes its last
// cell (cell (r, d - r) is computed at step d - r mod K).  A dead pair
// writes +inf and its block stops, as the plain version's sweep would
// within K anti-diagonals.
#define K5R_THREADS 512

// the step after which every cell of anti-diagonal d is computed (-1 for an
// anti-diagonal without cells): d less the least r mod K over its rows
template <int K>
__device__ __forceinline__ int k5r_done_step(int d, int L, int wb) {
    if (d < 0) return -1;
    const int rmin = max(max(0, d - (L - 1)), (d - wb + 1) >> 1);
    const int rmax = min(min(L - 1, d), (d + wb) >> 1);
    if (rmin > rmax) return -1;
    return (rmin + K - 1) / K * K <= rmax ? d : d - rmin % K;
}

template <int K>
__global__ void __launch_bounds__(K5R_THREADS, 1)
dtw_band_rows_kernel(const float* __restrict__ a,
                     const float* __restrict__ b,
                     const float* __restrict__ cutoff,
                     float* __restrict__ out, int L, int wb, int R,
                     int nbound) {
    constexpr int NB = K + 2;           // boundary slots
    extern __shared__ float k5r_smem[];
    float* ring = k5r_smem;             // [K + 1][threads]: last rows by step
    unsigned int* fm = reinterpret_cast<unsigned int*>(
        ring + (K + 1) * K5R_THREADS);  // [NB]: boundary minima, b mod NB
    const long long p = blockIdx.x;
    const float cut = cutoff[p];
    if (cut == -RT_INF) {               // an invalid slot: +inf at once
        if (threadIdx.x == 0) out[p] = RT_INF;
        return;
    }
    const int g = threadIdx.x;
    const int D = 2 * L - 1;
    for (int e = g; e < (K + 1) * K5R_THREADS; e += K5R_THREADS)
        ring[e] = RT_INF;
    if (g < NB) fm[g] = __float_as_uint(RT_INF);
    const float* ap = a + (size_t)p * L;
    const float* bp = b + (size_t)p * L;
    const int r0 = g * K;
    float av[K], left[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        av[k] = r0 + k < L ? __ldg(ap + r0 + k) : 0.f;
        left[k] = RT_INF;               // D(r, j - 1)
    }
    float last = RT_INF;                // D(r0 + K - 1, j) of this step
    float diag_in = g == 0 ? 0.f : RT_INF;      // D(r0 - 1, j - 1)
    float val = RT_INF;                 // D(L - 1, L - 1)
    // the first boundary this thread may still have cells of
    int fb = 0;
    int fdb = min(R - 1, D - 1);
    // the first boundary the block has not decided, and its step
    int bi = 0;
    int tb = max(k5r_done_step<K>(fdb - 1, L, wb),
                 k5r_done_step<K>(fdb, L, wb));
    bool dead = false;
    __syncthreads();
    const int tau_end = (L - 1) + (L - 1) / K * K;
    for (int tau = 0; tau <= tau_end; ++tau) {
        const int j = tau - r0;
        // thread g - 1's last row at column j, written at step tau - K
        const float up_in =
            g > 0 ? ring[((tau + 1) % (K + 1)) * K5R_THREADS + g - 1]
                  : RT_INF;
        if (j >= 0 && j < L && r0 < L) {
            const float bj = __ldg(bp + j);
            // rows of the band at column j: r in [j - wb, j + wb] and < L
            const int k_lo = j - wb - r0;
            const int k_hi = min(j + wb, L - 1) - r0;
            float up = up_in, diag = diag_in;
            if (k_lo <= 0 && k_hi >= K - 1) {
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    const float diff = __fsub_rn(av[k], bj);
                    const float cost = __fmul_rn(diff, diff);
                    const float nd = __fadd_rn(
                        cost, fminf(fminf(left[k], diag), up));
                    diag = left[k];
                    left[k] = nd;
                    up = nd;
                }
            } else {
#pragma unroll
                for (int k = 0; k < K; ++k) {
                    float nd = RT_INF;
                    if (k >= k_lo && k <= k_hi) {
                        const float diff = __fsub_rn(av[k], bj);
                        const float cost = __fmul_rn(diff, diff);
                        nd = __fadd_rn(cost,
                                       fminf(fminf(left[k], diag), up));
                    }
                    diag = left[k];
                    left[k] = nd;
                    up = nd;
                }
            }
            last = up;
            if (j == L - 1 && L - 1 < r0 + K) {
#pragma unroll
                for (int k = 0; k < K; ++k)
                    if (r0 + k == L - 1) val = left[k];
            }
            // fold the cells of boundary anti-diagonals: this step's cells
            // lie on tau .. tau + K - 1
            while (fdb < tau) {
                ++fb;
                fdb = min((fb + 1) * R - 1, D - 1);
            }
            for (int bb = fb, dbb = fdb; bb < nbound && dbb - 1 < tau + K;) {
                float v = RT_INF;
#pragma unroll
                for (int k = 0; k < K; ++k)
                    if (tau + k == dbb || tau + k == dbb - 1)
                        v = fminf(v, left[k]);
                if (v < RT_INF) atomicMin(&fm[bb % NB], __float_as_uint(v));
                ++bb;
                dbb = min((bb + 1) * R - 1, D - 1);
            }
        }
        ring[(tau % (K + 1)) * K5R_THREADS + g] = last;
        diag_in = up_in;
        __syncthreads();
        while (bi < nbound && tb <= tau) {
            const bool over = __uint_as_float(fm[bi % NB]) > cut;
            __syncthreads();            // every thread has read the slot
            if (g == 0) fm[bi % NB] = __float_as_uint(RT_INF);
            dead = dead || over;
            ++bi;
            const int dbi = min((bi + 1) * R - 1, D - 1);
            tb = max(k5r_done_step<K>(dbi - 1, L, wb),
                     k5r_done_step<K>(dbi, L, wb));
        }
        if (dead) break;
    }
    if (g == (L - 1) / K) out[p] = dead ? RT_INF : val;
}

template <int K>
static int rows_launch_k(const float* a, const float* b, const float* cutoff,
                         float* out, long long P, int L, int wb, int R,
                         cudaStream_t stream) {
    const int D = 2 * L - 1;
    const int nbound = (D + R - 1) / R;
    const long long smem = 4LL * ((K + 1) * K5R_THREADS + K + 2);
    int e = set_smem((const void*)dtw_band_rows_kernel<K>, smem);
    if (e) return e;
    dtw_band_rows_kernel<K><<<(unsigned)P, K5R_THREADS, (size_t)smem,
                              stream>>>(a, b, cutoff, out, L, wb, R, nbound);
    return (int)cudaGetLastError();
}

// Form (a): one block of K5R_THREADS per pair, K rows a thread, the
// smallest K of {4, 8, ..., 40} with K5R_THREADS K >= L (the wrapper has
// checked L <= 20480).
extern "C" int dtw_band_stream_rows_launch(const float* a, const float* b,
                                           const float* cutoff, float* out,
                                           long long P, int L, int wb,
                                           int R, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int K = (L + K5R_THREADS - 1) / K5R_THREADS;
    switch ((K + 3) / 4) {
#define K5R_CASE(q) \
    case q:         \
        return rows_launch_k<4 * q>(a, b, cutoff, out, P, L, wb, R, s);
        K5R_CASE(1) K5R_CASE(2) K5R_CASE(3) K5R_CASE(4) K5R_CASE(5)
        K5R_CASE(6) K5R_CASE(7) K5R_CASE(8) K5R_CASE(9) K5R_CASE(10)
#undef K5R_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// Form (b): a cluster of n blocks per pair (2 <= n <= 8), each holding an
// even slice of ceil((2wb + 1) / n) slots (the wrapper has checked that
// it fits K5_BLOCK_FLOATS).
extern "C" int dtw_band_stream_cluster_launch(const float* a,
                                              const float* b,
                                              const float* cutoff,
                                              float* out, long long P,
                                              int L, int wb, int R, int n,
                                              void* stream) {
    if (n < 2 || n > K5_MAX_CLUSTER) return (int)cudaErrorInvalidValue;
    int S = (2 * wb + 1 + n - 1) / n;
    S += S & 1;
    if (S > K5_BLOCK_FLOATS) return (int)cudaErrorInvalidValue;
    const long long smem = 4LL * S;
    int e = set_smem((const void*)dtw_band_cluster_kernel, smem);
    if (e) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(P * n), 1, 1);
    cfg.blockDim = dim3(dtw_band_threads(S / 2), 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, dtw_band_cluster_kernel, a, b,
                                         cutoff, out, L, wb, R, S);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// Form (c): the persistent grid of csrc/dtw_band.cuh with its band state
// in a device-memory scratch of (grid, 2, 2wb + 1) floats.
extern "C" int dtw_band_stream_scratch_launch(const float* a,
                                              const float* b,
                                              const float* cutoff,
                                              float* out, float* scratch,
                                              int grid, long long P, int L,
                                              int wb, int R, void* stream) {
    dtw_band_kernel<false, true>
        <<<grid, dtw_band_threads(wb), 0, (cudaStream_t)stream>>>(
            a, b, cutoff, out, scratch, P, L, wb, R);
    return (int)cudaGetLastError();
}
