"""Banded (Sakoe-Chiba) DTW, plain PyTorch (port of ``repro.core.dtw``).

Band-packed layout: a cell is addressed by its anti-diagonal ``d = i + j``
and its diagonal offset ``k = i - j + w`` in ``[0, 2w]``, so the state per
anti-diagonal is a dense ``Wb = 2w + 1`` vector and the recurrence is
shifts in ``k``:

    S_d[k] = cost(i, j) + min(S_{d-1}[k-1], S_{d-1}[k+1], S_{d-2}[k])

with ``i = (d + k - w) / 2`` (cells exist only where ``d + k - w`` is
even).  The cost operands are contiguous slices of the 2x-duplicated
series ``A2[t] = a[t // 2]`` and the flipped duplicate of ``b``.

Row-block abandon (``dtw_band_blocked``): anti-diagonals are grouped into
``row_block_policy(L)``-sized blocks, and only at a block boundary
(``(d + 1) % R == 0`` or ``d == D - 1``) is the frontier minimum
``min over lanes of min(S_d, S_{d-1})`` tested against the per-pair
``cutoff``.  Every warping path crosses anti-diagonal ``d`` or ``d - 1``
and prefix costs only grow, so that minimum lower-bounds the final DTW;
a pair whose minimum is strictly greater than its cutoff returns
``+inf``.  These are the JAX package's rules exactly, and the banded-DTW
kernel (kernels/dtw_band.py) applies the same ones, so the kernel and
this plain version are bit-comparable: the cell update is an unfused
multiply and add here and in the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_INF = float("inf")


def row_block_policy(L: int) -> int:
    """Anti-diagonals per row block: ~8 blocks per sweep, 64-step
    multiples (the JAX package's policy, so abandon checks land on the
    same boundaries)."""
    D = 2 * L - 1
    return min(D, max(64, -(-(D // 8) // 64) * 64))


def _band_width(L: int, w: int | None) -> int:
    """``wb``: ``None`` or ``w >= L`` is unconstrained, and
    ``|i - j| <= L - 1`` always holds."""
    if w is None or w >= L:
        w = L
    return min(w, L - 1)


def _pack(a: Tensor, b: Tensor, wb: int) -> tuple[Tensor, Tensor]:
    """``a2p[:, wb + t] = a[:, t // 2]`` and
    ``b2p[:, wb + t] = b[:, (2L - 1 - t) // 2]``, zero elsewhere."""
    L = a.shape[-1]
    pad_len = 2 * L + (2 * wb + 1) + wb
    a2 = a.repeat_interleave(2, dim=-1)
    b2f = b.repeat_interleave(2, dim=-1).flip(-1)
    right = pad_len - wb - 2 * L
    return F.pad(a2, (wb, right)), F.pad(b2f, (wb, right))


def band_step(d: int, carry, a2p: Tensor, b2p: Tensor, kk: Tensor,
              *, L: int, w: int) -> tuple[Tensor, Tensor]:
    """One anti-diagonal of the recurrence (no abandon test).

    ``carry = (S_{d-1}, S_{d-2})`` as ``(P, Wb)`` blocks; returns
    ``(S_d, S_{d-1})``.  ``kk`` is the ``(Wb,)`` diagonal-offset iota.
    """
    d1, d2 = carry
    Wb = d1.shape[-1]
    a_at = a2p[:, d:d + Wb]                            # a[(d + k - w) // 2]
    b_at = b2p[:, 2 * L - 1 - d:2 * L - 1 - d + Wb]    # b[(d - k + w) // 2]
    diff = a_at - b_at
    cost = diff * diff
    inf_col = torch.full_like(d1[:, :1], _INF)
    dep_l = torch.cat([inf_col, d1[:, :-1]], dim=-1)   # S_{d-1}[k-1]
    dep_r = torch.cat([d1[:, 1:], inf_col], dim=-1)    # S_{d-1}[k+1]
    best = torch.minimum(torch.minimum(dep_l, dep_r), d2)
    if d == 0:
        best = torch.where(kk == w, 0.0, best)         # the path's origin
    nd = cost + best
    t = d + kk - w                                     # 2i
    s = d - kk + w                                     # 2j
    valid = ((t & 1) == 0) & (t >= 0) & (t <= 2 * L - 2) \
        & (s >= 0) & (s <= 2 * L - 2)
    return torch.where(valid, nd, _INF), d1


def dtw_band_blocked(a: Tensor, b: Tensor, w: int | None = None,
                     cutoff: Tensor | float | None = None, *,
                     row_block: int | None = None) -> Tensor:
    """Batched band-packed DTW ``(P, L) x (P, L) -> (P,)`` with the
    row-block abandon checks (module docstring).

    ``cutoff`` is a per-pair ``(P,)`` threshold or a scalar; ``None``
    never abandons.  Below its cutoff a pair's value is exact.
    """
    P, L = a.shape
    wb = _band_width(L, w)
    Wb = 2 * wb + 1
    dev, dt = a.device, a.dtype
    if cutoff is None:
        cut = torch.full((P, 1), _INF, dtype=dt, device=dev)
    else:
        cut = torch.as_tensor(cutoff, dtype=dt, device=dev)
        cut = cut.expand(P).reshape(P, 1)
    R = row_block if row_block is not None else row_block_policy(L)
    D = 2 * L - 1
    R = max(1, min(R, D))
    a2p, b2p = _pack(a, b, wb)
    kk = torch.arange(Wb, device=dev)
    d1 = torch.full((P, Wb), _INF, dtype=dt, device=dev)
    d2 = d1.clone()
    for d in range(D):
        nd, d1 = band_step(d, (d1, d2), a2p, b2p, kk, L=L, w=wb)
        if (d + 1) % R == 0 or d == D - 1:
            fmin = torch.minimum(nd, d1).amin(dim=-1, keepdim=True)
            dead = fmin > cut
            nd = torch.where(dead, _INF, nd)
            d1 = torch.where(dead, _INF, d1)
        d1, d2 = nd, d1
    return d1[:, wb]


def dtw(a: Tensor, b: Tensor, w: int | None = None,
        cutoff: float | None = None) -> Tensor:
    """Scalar ``DTW_w(a, b)`` of two ``(L,)`` series, abandon tested at
    every step (the JAX scalar ``dtw``'s rule): exact below ``cutoff``,
    ``+inf`` once the frontier minimum passes it."""
    return dtw_band_blocked(a[None], b[None], w, cutoff, row_block=1)[0]
