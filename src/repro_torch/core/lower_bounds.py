"""DTW lower bounds, plain PyTorch (port of ``repro.core.lower_bounds``):
LB_KIM, LB_YI, LB_KEOGH, LB_IMPROVED, LB_NEW and the paper's
LB_ENHANCED^V, with the ``get_bound`` registry.

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
from repro_torch.core.envelopes import envelope

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


def lb_kim_paper(a: Tensor, b: Tensor) -> Tensor:
    """The paper's experimental LB_KIM variant: the sum of the four
    features, dropping the max/min features when that point is first or
    last (``repro.core.lower_bounds.lb_kim_paper``)."""
    L = a.shape[-1]
    res = delta(a[..., 0], b[..., 0]) + delta(a[..., -1], b[..., -1])
    ok_max = _interior(a.argmax(-1), L) & _interior(b.argmax(-1), L)
    ok_min = _interior(a.argmin(-1), L) & _interior(b.argmin(-1), L)
    res = res + torch.where(ok_max, delta(a.amax(-1), b.amax(-1)), 0.0)
    return res + torch.where(ok_min, delta(a.amin(-1), b.amin(-1)), 0.0)


def lb_yi(a: Tensor, b: Tensor) -> Tensor:
    """LB_YI: ``a``'s excursions beyond ``b``'s global max and min."""
    over = torch.clamp(a - b.amax(-1, keepdim=True), min=0.0)
    under = torch.clamp(b.amin(-1, keepdim=True) - a, min=0.0)
    return (over * over + under * under).sum(-1)


def lb_keogh_env(a: Tensor, u: Tensor, lo: Tensor) -> Tensor:
    """LB_KEOGH against a precomputed candidate envelope ``(u, lo)``."""
    over = torch.clamp(a - u, min=0.0)
    under = torch.clamp(lo - a, min=0.0)
    return (over * over + under * under).sum(-1)


def lb_keogh(a: Tensor, b: Tensor, w: int) -> Tensor:
    """LB_KEOGH of ``a`` against ``b``'s window-``w`` envelope."""
    u, lo = envelope(b, w)
    return lb_keogh_env(a, u, lo)


def lb_keogh_matrix(q: Tensor, u: Tensor, lo: Tensor) -> Tensor:
    """``(Q, L) x (C, L)``-envelopes ``-> (Q, C)`` Keogh block."""
    return lb_keogh_env(q[:, None, :], u[None, :, :], lo[None, :, :])


def lb_improved(a: Tensor, b: Tensor, w: int) -> Tensor:
    """Lemire's two-pass LB_IMPROVED: LB_KEOGH plus LB_KEOGH of ``b``
    against the envelope of ``a`` projected onto ``b``'s envelope."""
    u, lo = envelope(b, w)
    first = lb_keogh_env(a, u, lo)
    up, lp = envelope(torch.minimum(torch.maximum(a, lo), u), w)
    return first + lb_keogh_env(b, up, lp)


def lb_new(a: Tensor, b: Tensor, w: int) -> Tensor:
    """LB_NEW for ``(L,)`` series: boundary links plus, for each interior
    ``i``, the least cost of ``a_i`` against ``b``'s window around ``i``."""
    L = a.shape[-1]
    w = min(w, L)
    res = delta(a[0], b[0]) + delta(a[-1], b[-1])
    jj = (torch.arange(L, device=a.device)[:, None]
          + torch.arange(-w, w + 1, device=a.device)[None, :])
    valid = (jj >= 0) & (jj < L)
    d = delta(a[:, None], b[jj.clamp(0, L - 1)])
    per_i = torch.where(valid, d, _INF).amin(-1)
    return res + per_i[1:-1].sum()


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


def lb_enhanced(a: Tensor, b: Tensor, w: int, v: int) -> Tensor:
    """LB_ENHANCED^V with ``b``'s envelope computed here."""
    u, lo = envelope(b, w)
    return lb_enhanced_env(a, b, u, lo, w, v)


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


def get_bound(name: str, w: int, v: int = 4):
    """A ``fn(a, b) -> bound`` closure for a named bound (the names of
    ``repro.core.lower_bounds.get_bound``; ``lb_enhanced_<V>`` picks V)."""
    name = name.lower()
    if name == "lb_kim":
        return lb_kim
    if name == "lb_kim_paper":
        return lb_kim_paper
    if name == "lb_yi":
        return lb_yi
    if name == "lb_keogh":
        return lambda a, b: lb_keogh(a, b, w)
    if name == "lb_improved":
        return lambda a, b: lb_improved(a, b, w)
    if name == "lb_new":
        return lambda a, b: lb_new(a, b, w)
    if name.startswith("lb_enhanced"):
        vv = int(name.rsplit("_", 1)[-1]) if name[-1].isdigit() else v
        return lambda a, b: lb_enhanced(a, b, w, vv)
    raise ValueError(f"unknown lower bound: {name!r}")


BOUND_NAMES = ("lb_kim", "lb_keogh", "lb_improved", "lb_new",
               "lb_enhanced_1", "lb_enhanced_2", "lb_enhanced_3",
               "lb_enhanced_4")
