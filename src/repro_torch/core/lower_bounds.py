"""DTW lower bounds used by the cascade, plain PyTorch (port of
``repro.core.lower_bounds``): LB_KIM, LB_KEOGH and the paper's
LB_ENHANCED^V.

All bounds lower-bound the squared-cost ``D(L, L)`` for any Sakoe-Chiba
half-width ``w``.  ``*_matrix`` variants give ``(Q, C)`` blocks.

The elastic-band sum has one fixed order, shared with the LB_ENHANCED
kernels (csrc/lb_enhanced.cu, csrc/lb_enhanced_pairwise.cu): the left
band minima are added for band 0, 1, ..., nb-1 starting from zero, the
right band minima likewise, and the result is ``left + right``.  That is
what lets the bands-only kernel be bit-equal to this plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.distances import delta

Tensor = torch.Tensor

_INF = float("inf")


def _interior(idx: Tensor, L: int) -> Tensor:
    return (idx != 0) & (idx != L - 1)


def lb_kim(a: Tensor, b: Tensor) -> Tensor:
    """Provably safe Kim bound: boundary links plus the larger of the
    max/min feature terms, each admitted only when its witness index is
    interior (``repro.core.lower_bounds.lb_kim``)."""
    L = a.shape[-1]
    res = delta(a[..., 0], b[..., 0]) + delta(a[..., -1], b[..., -1])
    amax, bmax = a.amax(-1), b.amax(-1)
    amin, bmin = a.amin(-1), b.amin(-1)
    ia = torch.where(amax >= bmax, a.argmax(-1), b.argmax(-1))
    t_max = torch.where(_interior(ia, L), delta(amax, bmax), 0.0)
    im = torch.where(amin <= bmin, a.argmin(-1), b.argmin(-1))
    t_min = torch.where(_interior(im, L), delta(amin, bmin), 0.0)
    return res + torch.maximum(t_max, t_min)


def lb_keogh_env(a: Tensor, u: Tensor, lo: Tensor) -> Tensor:
    """LB_KEOGH against a precomputed candidate envelope ``(u, lo)``."""
    over = torch.clamp(a - u, min=0.0)
    under = torch.clamp(lo - a, min=0.0)
    return (over * over + under * under).sum(-1)


def _n_bands(L: int, w: int, v: int) -> int:
    """Algorithm 1 line 2: ``nb = min(L // 2, w, v)``."""
    return max(0, min(L // 2, w, v))


def _band_minima(a: Tensor, b: Tensor, nb: int) -> Tensor:
    """Sum of the ``nb`` left and ``nb`` right elastic-band minima
    (paper Eqs. 11-12) for broadcastable ``(..., L)`` operands.

    Left band ``i`` is L-shaped: cells ``delta(a_j, b_i)`` and
    ``delta(a_i, b_j)`` for ``j in [0, i]``; the right band mirrors it
    around ``L - 1``.  Summed in the fixed order of the module docstring.
    """
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    zero = torch.zeros(shape, dtype=a.dtype, device=a.device)
    if nb == 0:
        return zero
    L = a.shape[-1]

    def band(i: int, j0: int, sign: int) -> Tensor:
        # arm cells (a[j], b[i]) and (a[i], b[j]) for j = i - sign * t
        m = torch.full(shape, _INF, dtype=a.dtype, device=a.device)
        for t in range(j0 + 1):
            j = i - sign * t
            m = torch.minimum(m, torch.minimum(delta(a[..., j], b[..., i]),
                                               delta(a[..., i], b[..., j])))
        return m

    left, right = zero, zero
    for bi in range(nb):
        left = left + band(bi, bi, 1)
    for bi in range(nb):
        right = right + band(L - 1 - bi, bi, -1)
    return left + right


def lb_enhanced_bands(a: Tensor, b: Tensor, w: int, v: int) -> Tensor:
    """Bands-only partial bound (Algorithm 1 lines 1-11), itself a valid
    lower bound and the cascade's ``bands`` tier."""
    return _band_minima(a, b, _n_bands(a.shape[-1], w, v))


def _bridge(a: Tensor, u: Tensor, lo: Tensor, nb: int) -> Tensor:
    """Keogh bridge over ``i in [nb, L - nb)``."""
    L = a.shape[-1]
    return lb_keogh_env(a[..., nb:L - nb], u[..., nb:L - nb],
                        lo[..., nb:L - nb])


def lb_enhanced_env(a: Tensor, b: Tensor, u: Tensor, lo: Tensor,
                    w: int, v: int) -> Tensor:
    """LB_ENHANCED^V (Eq. 14) with a precomputed candidate envelope:
    elastic bands plus the Keogh bridge, elementwise over leading axes."""
    nb = _n_bands(a.shape[-1], w, v)
    return _band_minima(a, b, nb) + _bridge(a, u, lo, nb)


def lb_enhanced_matrix(q: Tensor, c: Tensor, u: Tensor, lo: Tensor,
                       w: int, v: int) -> Tensor:
    """``(Q, L) x (C, L) -> (Q, C)`` LB_ENHANCED^V block."""
    return lb_enhanced_env(q[:, None, :], c[None, :, :], u[None, :, :],
                           lo[None, :, :], w, v)
