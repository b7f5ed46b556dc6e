"""Plain PyTorch versions of the four kernels (port of
``repro.kernels.ref``).

Each ``*_ref`` has its kernel's semantics exactly: the same shapes, the
same ``live`` / ``bands_only`` / ``cutoff`` / ``perm`` rules.  The CPU
path of ``kernels/ops.py`` runs these, the tests hold them against the
JAX package, and ``chip_smoke.py`` holds each kernel against them on the
card.
"""

from __future__ import annotations

import torch

from repro_torch.core import envelopes as _env
from repro_torch.core import lower_bounds as _lb
from repro_torch.core.dtw import dtw_band_blocked
from repro_torch.kernels.tiling import apply_pair_perm

Tensor = torch.Tensor

_INF = float("inf")


def _mask_dead(out: Tensor, live: Tensor | None) -> Tensor:
    """Dead entries of ``live`` (broadcast along the last axis) become
    ``-inf``, the running-max identity."""
    if live is None:
        return out
    live = torch.as_tensor(live, device=out.device).bool()
    return torch.where(live, out, -_INF)


def envelope_ref(b: Tensor, w: int) -> tuple[Tensor, Tensor]:
    """``(N, L) -> ((N, L), (N, L))`` upper/lower envelopes."""
    return _env.envelope(b, min(w, b.shape[-1]))


def lb_enhanced_ref(q: Tensor, c: Tensor, u: Tensor, lo: Tensor, w: int,
                    v: int, *, live: Tensor | None = None,
                    bands_only: bool = False) -> Tensor:
    """``(Q, L) x (C, L) -> (Q, C)`` LB_ENHANCED^V or its bands-only tier.

    ``live`` (``(C,)``): dead candidates return ``-inf`` down their whole
    column.  The plain version computes everything and masks.
    """
    if bands_only:
        out = _lb.lb_enhanced_bands(q[:, None, :], c[None, :, :], w, v)
    else:
        out = _lb.lb_enhanced_matrix(q, c, u, lo, w, v)
    return _mask_dead(out, live)


def lb_enhanced_pairwise_ref(q: Tensor, c: Tensor, u: Tensor, lo: Tensor,
                             w: int, v: int, *, live: Tensor | None = None,
                             bands_only: bool = False) -> Tensor:
    """Pairwise ``(P, L) x (P, L) -> (P,)`` LB_ENHANCED^V: row ``p`` of
    the queries with row ``p`` of the candidates.  ``live`` (``(P,)``):
    dead slots return ``-inf``."""
    if bands_only:
        out = _lb.lb_enhanced_bands(q, c, w, v)
    else:
        out = _lb.lb_enhanced_env(q, c, u, lo, w, v)
    return _mask_dead(out, live)


def dtw_band_ref(a: Tensor, b: Tensor, w: int | None = None,
                 cutoff=None, *, row_block: int | None = None,
                 perm: Tensor | None = None,
                 tile_p: int | None = None) -> Tensor:
    """Pairwise banded DTW ``(P, L), (P, L) -> (P,)`` with the kernel's
    per-pair ``cutoff`` and row-block abandon rule.

    ``perm`` is the pair-packing gather (a no-op on results); ``tile_p``
    is packing geometry and is accepted and ignored, so the engine can
    make one call shape on both routes.
    """
    del tile_p
    if perm is not None:
        return apply_pair_perm(
            lambda x, y, c: dtw_band_ref(x, y, w, c, row_block=row_block),
            perm, a, b, cutoff,
        )
    return dtw_band_blocked(a, b, w, cutoff, row_block=row_block)
