"""Banded-DTW wrappers on the card: K4 and K6 (csrc/dtw_band.cu, three
forms) and K5 (csrc/dtw_band_stream.cu, three forms), one entry point,
``dtw_band_cuda``.

- K4 replaces ``src/repro/kernels/dtw_band.py:dtw_band_pallas``
  (``_dtw_band_kernel_blocked``), with a frontier minimum at each
  ``row_block_policy`` boundary; a dead pair writes ``+inf`` and stops.
  ``k4_form(L, w)`` picks one of two forms: ``"warp"`` (wb <= 255, the
  search paths' w = 51), one warp per pair, lane l holding the band slots
  ``[l M, l M + M)`` in registers (M in {2, 4, 8, 16}), one warp shuffle
  a step for the neighbour outside the lane and none of the block's
  barriers; ``"slots"`` (255 < wb <= 14463, the paper's large windows),
  the same slots over G = ceil((2 wb + 1) / (32 M)) warps a pair
  (``k4_slots`` picks M), the slots at warp edges through shared memory
  with one ``__syncthreads`` a step when G > 1, and each lane's windows
  of the two series in registers.  A third form, ``"block"`` (one block
  per pair, threads over the valid cells of each anti-diagonal, the two
  previous anti-diagonals in shared memory and a ``__syncthreads`` a
  step), runs only when forced, as the slots form's baseline.
- K6 replaces ``_dtw_band_kernel`` (``early_exit=False``): the same three
  forms with the frontier tested at every anti-diagonal, dead state
  poisoned to ``+inf`` and no early return.  Equal outputs; a baseline.
- K5 replaces ``_dtw_band_pallas_stream``, for bands whose two buffers
  do not fit a block's shared memory.  ``k5_form(L, w)`` picks one of
  three forms: ``"rows"`` (L <= 20480), one block of 512 threads per
  pair, each thread K <= 40 consecutive rows in registers, the block
  sweeping K anti-diagonals a step; ``"cluster"`` (wb <= 231423),
  S_{d-1} and S_{d-2} interleaved in one shared-memory buffer of
  ``2 wb + 1`` slots cut into slices over a thread-block cluster of 2-8
  blocks, the slice edges read through distributed shared memory;
  ``"scratch"``, the band state in a device-memory scratch of
  ``(grid, 2, 2 wb + 1)`` floats allocated here, a persistent grid of
  blocks looping over pairs.

K4's and K6's block form and K5's form ``"scratch"`` share one kernel
body (``csrc/dtw_band.cuh``); the others have their own.  Each form has
its own launch count: ``dtw_band``, ``dtw_band_slots`` and
``dtw_band_block`` (K4), ``dtw_band_step``, ``dtw_band_step_slots`` and
``dtw_band_step_block`` (K6), ``dtw_band_stream``,
``dtw_band_stream_cluster`` and ``dtw_band_stream_scratch`` (K5).  Bound
on this card: FP32 operations, 5 per band cell over ``L(2w+1) - w(w+1)``
cells per pair (6 for K6), against 8 L bytes per pair.
``dtw_band_route`` decides K4 against K5 from ``(L, w)``.
"""

from __future__ import annotations

import torch

from repro_torch.core.dtw import _band_width, row_block_policy
from repro_torch.kernels import _build
from repro_torch.kernels._launch import cuda_f32, stream_ptr

Tensor = torch.Tensor

_INF = float("inf")

# K4 keeps 2 (2 wb + 1) f32 in dynamic shared memory and leaves 1 KB of
# the 232,448 bytes a block may opt into on sm_90 free; this is the one
# definition of the K4/K5 crossover (csrc/dtw_band.cu launches what it
# admits)
_RESIDENT_SMEM_BYTES = 232448 - 1024
# K5's on-chip forms: the longest series form "rows" holds (512 threads of
# at most 40 rows), the floats of band state one block of form "cluster"
# holds, and the largest portable thread-block cluster
K5_ROWS_MAX_L = 512 * 40
K5_BLOCK_FLOATS = _RESIDENT_SMEM_BYTES // 4
K5_MAX_CLUSTER = 8
K5_FORMS = ("rows", "cluster", "scratch")
# K4's forms; the warp form holds the 2 wb + 1 slots of the band in 32
# lanes of at most 16 registers
K4_FORMS = ("warp", "slots", "block")
K4_WARP_MAX_WB = (32 * 16 - 1) // 2
# the slots form: one warp a pair of at least 22 slots a lane (fewer made
# ptxas spill) while 32 lanes of at most 32 hold the band, else 32 slots a
# lane in up to 16 warps a block, in a cluster of two blocks past that
K4_SLOTS_ONE_WARP = range(22, 33, 2)
# K5's scratch form: persistent-grid blocks per SM (fewer when there are
# fewer pairs)
STREAM_BLOCKS_PER_SM = 2


def dtw_band_route(L: int, w: int | None) -> str:
    """``"resident"`` (K4) while the band's two anti-diagonals fit one
    block's shared memory, else ``"stream"`` (K5): K5 exactly for
    ``wb > 14463``, ``wb = min(w, L - 1)``."""
    wb = _band_width(L, w)
    return ("resident" if 2 * (2 * wb + 1) * 4 <= _RESIDENT_SMEM_BYTES
            else "stream")


def k4_form(L: int, w: int | None) -> str:
    """K4's (and K6's) form for ``(L, w)``: ``"warp"`` while the band's
    ``2 wb + 1`` slots fit a warp's registers (wb <= 255), else
    ``"slots"`` (up to the K4/K5 crossover, wb <= 14463)."""
    return "warp" if _band_width(L, w) <= K4_WARP_MAX_WB else "slots"


def slots_warps(wb: int, m: int) -> int:
    """The slots form's warps a pair: ``ceil((2 wb + 1) / (32 m))``."""
    return -(-(2 * wb + 1) // (32 * m))


def k4_slots(L: int, w: int | None) -> int:
    """The slots form's slots a lane for ``(L, w)``: one warp a pair with
    the fewest even slots (at least 22) while the band's ``2 wb + 1``
    slots fit 32 lanes of 32 (wb <= 511), else 32 (2-16 warps a block up
    to wb = 8191, a cluster of two blocks past that: 29 warps at
    wb = 14463)."""
    need = -(-(2 * _band_width(L, w) + 1) // 32)
    return max(K4_SLOTS_ONE_WARP[0], need + (need & 1)) if need <= 32 else 32


def k5_form(L: int, w: int | None) -> str:
    """K5's form for ``(L, w)``: ``"rows"`` while L <= 20480,
    ``"cluster"`` while the ``2 wb + 1`` slots of the band fit
    ``K5_MAX_CLUSTER`` blocks (wb <= 231423), else ``"scratch"``."""
    wb = _band_width(L, w)
    if L <= K5_ROWS_MAX_L:
        return "rows"
    if 2 * wb + 1 <= K5_MAX_CLUSTER * K5_BLOCK_FLOATS:
        return "cluster"
    return "scratch"


def k5_cluster_size(L: int, w: int | None) -> int:
    """Blocks of K5's cluster form for ``(L, w)``: the fewest whose
    slices hold ``2 wb + 1`` slots, at least 2 (3 at L = 65536, w = L)."""
    wb = _band_width(L, w)
    return max(2, -(-(2 * wb + 1) // K5_BLOCK_FLOATS))


def dtw_band_cuda(a: Tensor, b: Tensor, w: int | None = None, cutoff=None,
                  *, row_block: int | None = None, early_exit: bool = True,
                  stream: bool = False, form: str | None = None,
                  cluster: int | None = None) -> Tensor:
    """Pairwise banded DTW ``(P, L), (P, L) -> (P,)`` on the card, with
    the row-block abandon rule of ``core.dtw.dtw_band_blocked``.

    K4, or K6 with ``early_exit=False`` (which tests every anti-diagonal,
    so ``row_block`` does not apply), in the form ``k4_form(L, w)``
    picks; ``form`` (one of ``K4_FORMS``) runs another, so both can be
    held against the plain version at the same shapes.  K4 and K6 raise
    where ``dtw_band_route`` says the band needs K5, and the warp form
    raises past wb = 255.  ``stream=True`` runs K5 at any shape, in the
    form ``k5_form(L, w)`` picks or ``form`` (one of ``K5_FORMS``);
    ``cluster`` sets the blocks of form ``"cluster"`` (2 to
    ``K5_MAX_CLUSTER``; by default ``k5_cluster_size``), so each cluster
    size can be held too.  K5 implies early exit, as the JAX streaming
    kernel does.
    """
    if a.dim() != 2:
        raise ValueError(f"a: expected (P, L), got {tuple(a.shape)}")
    P, L = a.shape
    cuda_f32("a", a)
    cuda_f32("b", b, (P, L), a.device)
    if cutoff is None:
        cut = torch.full((P,), _INF, dtype=a.dtype, device=a.device)
    else:
        cut = torch.as_tensor(cutoff, dtype=a.dtype, device=a.device)
        cut = cut.expand(P).contiguous()
    wb = _band_width(L, w)
    if form is not None and not stream:
        if form not in K4_FORMS:
            raise ValueError(f"form = {form!r}: expected one of {K4_FORMS} "
                             f"(or {K5_FORMS} with stream=True)")
        if form == "warp" and wb > K4_WARP_MAX_WB:
            raise ValueError(f"K4 warp form: band half-width {wb} > "
                             f"{K4_WARP_MAX_WB}, past a warp's registers")
    if form is not None and stream:
        if form not in K5_FORMS:
            raise ValueError(f"form = {form!r}: expected one of {K5_FORMS}")
        if form == "rows" and L > K5_ROWS_MAX_L:
            raise ValueError(f"K5 rows form: L = {L} > {K5_ROWS_MAX_L} "
                             "rows for its 512 threads")
        if form == "cluster" and k5_form(L, w) == "scratch":
            raise ValueError(f"K5 cluster form: band half-width {wb} needs "
                             f"more than {K5_MAX_CLUSTER} blocks")
    kform = form or (k5_form(L, w) if stream else k4_form(L, w))
    n_cluster = k5_cluster_size(L, w)
    if cluster is not None:
        if kform != "cluster":
            raise ValueError("cluster applies to K5's cluster form")
        if not n_cluster <= cluster <= K5_MAX_CLUSTER:
            raise ValueError(f"K5 cluster form: {cluster} blocks, expected "
                             f"{n_cluster} to {K5_MAX_CLUSTER} for band "
                             f"half-width {wb}")
        n_cluster = cluster
    if not stream and dtw_band_route(L, w) == "stream":
        raise ValueError(f"dtw_band kernel: band half-width {wb} needs "
                         "more shared memory than a block holds "
                         "(stream=True runs it)")
    lib = _build.library()
    out = torch.empty((P,), dtype=a.dtype, device=a.device)
    if P == 0 or L == 0:
        return out
    D = 2 * L - 1
    R = row_block if row_block is not None else row_block_policy(L)
    R = max(1, min(R, D))
    sp = stream_ptr(a.device)
    if kform == "rows":
        _build.check(lib.dtw_band_stream_rows_launch(
            a.data_ptr(), b.data_ptr(), cut.data_ptr(), out.data_ptr(), P,
            L, wb, R, sp), "dtw_band_stream")
        _build.COUNTS["dtw_band_stream"] += 1
    elif kform == "cluster":
        _build.check(lib.dtw_band_stream_cluster_launch(
            a.data_ptr(), b.data_ptr(), cut.data_ptr(), out.data_ptr(), P,
            L, wb, R, n_cluster, sp), "dtw_band_stream_cluster")
        _build.COUNTS["dtw_band_stream_cluster"] += 1
    elif kform == "scratch":
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        grid = min(P, STREAM_BLOCKS_PER_SM * sms)
        # freed at return: the caching allocator gives it out again only to
        # work queued after this launch on the same stream
        scratch = torch.empty((grid, 2, 2 * wb + 1), dtype=a.dtype,
                              device=a.device)
        _build.check(lib.dtw_band_stream_scratch_launch(
            a.data_ptr(), b.data_ptr(), cut.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), grid, P, L, wb, R, sp),
            "dtw_band_stream_scratch")
        _build.COUNTS["dtw_band_stream_scratch"] += 1
    else:
        # K4 (early exit) or K6, in form kform
        name = ("dtw_band" if early_exit else "dtw_band_step") + (
            "" if kform == "warp" else "_" + kform)
        args = [a.data_ptr(), b.data_ptr(), cut.data_ptr(), out.data_ptr(),
                P, L, wb] + ([R] if early_exit else []) + (
                    [k4_slots(L, w)] if kform == "slots" else [])
        _build.check(getattr(lib, name + "_launch")(*args, sp), name)
        _build.COUNTS[name] += 1
    return out
