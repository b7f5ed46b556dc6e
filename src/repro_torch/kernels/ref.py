"""Plain PyTorch versions of the six kernels (port of
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


def lb_keogh_ref(q: Tensor, u: Tensor, lo: Tensor, *,
                 chunk: int = 512) -> Tensor:
    """``(Q, L) x (C, L)`` envelopes ``-> (Q, C)`` LB_KEOGH matrix.

    Candidates are taken ``chunk`` at a time so the ``(Q, chunk, L)``
    intermediate stays bounded; each entry's sum over L is the same
    whatever the chunk.
    """
    outs = [_lb.lb_keogh_matrix(q, u[s:s + chunk], lo[s:s + chunk])
            for s in range(0, u.shape[0], chunk)]
    if not outs:
        return q.new_zeros((q.shape[0], 0))
    return torch.cat(outs, dim=1)


def sketch_operands(qbar: Tensor, sk_scale, seg_sizes) -> tuple[Tensor,
                                                                Tensor]:
    """The sketch bound's scaled-units operands: ``qs = qbar / scale``
    ``(Q, S)`` and ``wseg = n_j * scale * scale`` ``(S,)``, computed as
    the JAX package computes them (a true division, then two products)."""
    scale = torch.as_tensor(sk_scale, dtype=torch.float32,
                            device=qbar.device)
    qs = qbar.to(torch.float32) / scale
    wseg = torch.as_tensor(seg_sizes, dtype=torch.float32,
                           device=qbar.device) * scale * scale
    return qs.contiguous(), wseg.contiguous()


def sketch_bound_scaled(qs: Tensor, sk_lo: Tensor, sk_hi: Tensor,
                        wseg: Tensor) -> Tensor:
    """``(Q, S) x (N, S) int8 -> (Q, N)`` sketch bound in scaled units:
    ``sum_j wseg_j * max(qs_j - hi_j, lo_j - qs_j, 0)^2``.

    The segments are summed in the fixed order ``j = 0 .. S-1`` as
    ``acc + (wseg_j * d) * d``, each product and sum rounded on its own;
    the sketch kernel (csrc/sketch.cu) does the same, so the two are
    bit-equal.
    """
    lo = sk_lo.to(torch.float32)
    hi = sk_hi.to(torch.float32)
    acc = torch.zeros((qs.shape[0], lo.shape[0]), dtype=torch.float32,
                      device=qs.device)
    for j in range(qs.shape[1]):
        qj = qs[:, j:j + 1]
        d = torch.clamp(torch.maximum(qj - hi[None, :, j],
                                      lo[None, :, j] - qj), min=0.0)
        acc = acc + (wseg[j] * d) * d
    return acc


def sketch_bound_ref(qbar: Tensor, sk_lo: Tensor, sk_hi: Tensor, sk_scale,
                     seg_sizes) -> Tensor:
    """``(Q, S) f32 x (N, S) int8 -> (Q, N)`` tier-(-1) sketch bounds:
    the quantised segment-reduced LB_Keogh of ``search/index.py``, in the
    scaled-units form of ``repro.kernels.ref.sketch_bound_ref`` (the int8
    cells are compared without dequantising)."""
    qs, wseg = sketch_operands(qbar, sk_scale, seg_sizes)
    return sketch_bound_scaled(qs, sk_lo, sk_hi, wseg)


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
