"""K4 wrapper: banded DTW with per-pair cutoffs on the card
(csrc/dtw_band.cu).

Replaces ``src/repro/kernels/dtw_band.py:dtw_band_pallas``
(``_dtw_band_kernel_blocked``, packing ``_pack_band_operands``).  Bound
on this card: FP32 operations, ~5 per band cell over
``L(2w+1) - w(w+1)`` cells per pair, against 8 L bytes per pair.  Design:
one block per pair with threads over the band's diagonal offsets, the two
previous anti-diagonals in shared memory (one ``__syncthreads`` per
anti-diagonal), and a block-wide frontier minimum at each
``row_block_policy`` boundary; a dead pair writes ``+inf`` and its block
exits.  Raises when the band's two buffers exceed a block's shared
memory (``2 (2 wb + 1) 4`` bytes > 227 KB).
"""

from __future__ import annotations

import torch

from repro_torch.core.dtw import _band_width, row_block_policy
from repro_torch.kernels import _build
from repro_torch.kernels._launch import cuda_f32, stream_ptr

Tensor = torch.Tensor

_INF = float("inf")


def dtw_band_cuda(a: Tensor, b: Tensor, w: int | None = None, cutoff=None,
                  *, row_block: int | None = None) -> Tensor:
    """Pairwise banded DTW ``(P, L), (P, L) -> (P,)`` on the card, with
    the row-block abandon rule of ``core.dtw.dtw_band_blocked``."""
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
    lib = _build.library()
    if lib.dtw_band_smem_bytes(wb) < 0:
        raise ValueError(f"dtw_band kernel: band half-width {wb} needs "
                         "more shared memory than a block holds")
    out = torch.empty((P,), dtype=a.dtype, device=a.device)
    if P == 0 or L == 0:
        return out
    D = 2 * L - 1
    R = row_block if row_block is not None else row_block_policy(L)
    R = max(1, min(R, D))
    _build.check(lib.dtw_band_launch(a.data_ptr(), b.data_ptr(),
                                     cut.data_ptr(), out.data_ptr(), P, L,
                                     wb, R, stream_ptr(a.device)),
                 "dtw_band")
    _build.COUNTS["dtw_band"] += 1
    return out
