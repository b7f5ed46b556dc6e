"""Banded-DTW wrappers on the card: K4 and K6 (csrc/dtw_band.cu) and K5
(csrc/dtw_band_stream.cu), one entry point, ``dtw_band_cuda``.

- K4 replaces ``src/repro/kernels/dtw_band.py:dtw_band_pallas``
  (``_dtw_band_kernel_blocked``): one block per pair, threads over the
  valid cells of each anti-diagonal, the two previous anti-diagonals in
  shared memory, a block-wide frontier minimum at each ``row_block_policy``
  boundary; a dead pair writes ``+inf`` and its block exits.
- K6 replaces ``_dtw_band_kernel`` (``early_exit=False``): the same
  kernel with the frontier tested at every anti-diagonal, dead state
  poisoned to ``+inf`` and no early return.  Equal outputs; a baseline.
- K5 replaces ``_dtw_band_pallas_stream``: the band state in a
  device-memory scratch of ``(grid, 2, 2 wb + 1)`` floats allocated
  here, a persistent grid of blocks looping over pairs, for bands whose
  two buffers do not fit a block's shared memory.

The three share one kernel body (``csrc/dtw_band.cuh``).  Bound on this
card: FP32 operations, 5 per band cell over ``L(2w+1) - w(w+1)`` cells
per pair (6 for K6), against 8 L bytes per pair.
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
# K5's persistent grid: blocks per SM (fewer when there are fewer pairs)
STREAM_BLOCKS_PER_SM = 2


def dtw_band_route(L: int, w: int | None) -> str:
    """``"resident"`` (K4) while the band's two anti-diagonals fit one
    block's shared memory, else ``"stream"`` (K5): K5 exactly for
    ``wb > 14463``, ``wb = min(w, L - 1)``."""
    wb = _band_width(L, w)
    return ("resident" if 2 * (2 * wb + 1) * 4 <= _RESIDENT_SMEM_BYTES
            else "stream")


def dtw_band_cuda(a: Tensor, b: Tensor, w: int | None = None, cutoff=None,
                  *, row_block: int | None = None, early_exit: bool = True,
                  stream: bool = False) -> Tensor:
    """Pairwise banded DTW ``(P, L), (P, L) -> (P,)`` on the card, with
    the row-block abandon rule of ``core.dtw.dtw_band_blocked``.

    ``stream=True`` runs K5 at any shape; otherwise K4, or K6 with
    ``early_exit=False`` (which tests every anti-diagonal, so
    ``row_block`` does not apply).  K4 and K6 raise where
    ``dtw_band_route`` says the band needs K5; K5 implies early exit, as
    the JAX streaming kernel does.
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
    if stream:
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        grid = min(P, STREAM_BLOCKS_PER_SM * sms)
        # freed at return: the caching allocator gives it out again only to
        # work queued after this launch on the same stream
        scratch = torch.empty((grid, 2, 2 * wb + 1), dtype=a.dtype,
                              device=a.device)
        _build.check(lib.dtw_band_stream_launch(
            a.data_ptr(), b.data_ptr(), cut.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), grid, P, L, wb, R, sp), "dtw_band_stream")
        _build.COUNTS["dtw_band_stream"] += 1
    elif early_exit:
        _build.check(lib.dtw_band_launch(a.data_ptr(), b.data_ptr(),
                                         cut.data_ptr(), out.data_ptr(), P,
                                         L, wb, R, sp), "dtw_band")
        _build.COUNTS["dtw_band"] += 1
    else:
        _build.check(lib.dtw_band_step_launch(a.data_ptr(), b.data_ptr(),
                                              cut.data_ptr(),
                                              out.data_ptr(), P, L, wb, sp),
                     "dtw_band_step")
        _build.COUNTS["dtw_band_step"] += 1
    return out
