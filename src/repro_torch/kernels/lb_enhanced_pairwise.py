"""K3 wrapper: packed pairwise LB_ENHANCED^V on the card
(csrc/lb_enhanced_pairwise.cu).

Replaces ``src/repro/kernels/lb_enhanced_pairwise.py:
lb_enhanced_pairwise_pallas`` (``_lb_enhanced_pairwise_kernel``,
``_live``).  Bound on this card: memory, the pair's query and envelope
rows (16 L bytes per pair counting the candidate row) against ~8 L FP32
operations.  Design: one warp per pair, loads coalesced along L, the
bridge reduced with warp shuffles and the bands taken from the row's
ends.  ``live`` (``(P,)``) turns dead slots into ``-inf`` and their warps
skip the compute.
"""

from __future__ import annotations

import torch

from repro_torch.core.lower_bounds import _n_bands
from repro_torch.kernels import _build
from repro_torch.kernels._launch import cuda_f32, live_bytes, stream_ptr

Tensor = torch.Tensor


def lb_enhanced_pairwise_cuda(q: Tensor, c: Tensor, u: Tensor, lo: Tensor,
                              w: int, v: int, *, live: Tensor | None = None,
                              bands_only: bool = False) -> Tensor:
    """``(P, L) x (P, L) -> (P,)`` on the card."""
    if q.dim() != 2:
        raise ValueError(f"q: expected (P, L), got {tuple(q.shape)}")
    P, L = q.shape
    cuda_f32("q", q)
    cuda_f32("c", c, (P, L), q.device)
    if not bands_only:
        cuda_f32("u", u, (P, L), q.device)
        cuda_f32("lo", lo, (P, L), q.device)
    nb = _n_bands(L, w, v)
    lv = live_bytes(live, P, q.device)
    out = torch.empty((P,), dtype=q.dtype, device=q.device)
    if P == 0:
        return out
    lib = _build.library()
    _build.check(lib.lb_enhanced_pairwise_launch(
        q.data_ptr(), c.data_ptr(),
        None if bands_only else u.data_ptr(),
        None if bands_only else lo.data_ptr(),
        None if lv is None else lv.data_ptr(), out.data_ptr(),
        P, L, nb, int(bands_only), stream_ptr(q.device)),
        "lb_enhanced_pairwise")
    _build.COUNTS["lb_enhanced_pairwise"] += 1
    return out
