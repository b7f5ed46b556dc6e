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
    Cells off the matrix or of the other parity are ``+inf``.
    """
    d1, d2 = carry
    Wb = d1.shape[-1]
    a_at = a2p[:, d:d + Wb]                            # a[(d + k - w) // 2]
    b_at = b2p[:, 2 * L - 1 - d:2 * L - 1 - d + Wb]    # b[(d - k + w) // 2]
    diff = a_at - b_at
    cost = diff * diff
    dep_l = F.pad(d1[:, :-1], (1, 0), value=_INF)      # S_{d-1}[k-1]
    dep_r = F.pad(d1[:, 1:], (0, 1), value=_INF)       # S_{d-1}[k+1]
    best = torch.minimum(torch.minimum(dep_l, dep_r), d2)
    if d == 0:
        best = torch.where(kk == w, 0.0, best)         # the path's origin
    nd = cost + best
    # a cell exists where t = d + k - w (2i) is even and both t and
    # s = d - k + w (2j) lie in [0, 2L - 2]: a parity mask and a k range
    nd = torch.where((kk & 1) == ((d + w) & 1), nd, _INF)
    k_lo = max(w - d, d + w - (2 * L - 2))
    k_hi = min(d + w, 2 * L - 2 - d + w)
    if k_lo > 0:
        nd[:, :k_lo] = _INF
    if k_hi < Wb - 1:
        nd[:, max(k_hi + 1, 0):] = _INF
    return nd, d1


def _band_blocked_scan(a: Tensor, b: Tensor, w: int | None, cutoff,
                       row_block: int | None) -> tuple[Tensor, Tensor]:
    """The row-block-checked sweep: ``((P,) values, (P,) death)``, where
    ``death[p]`` is the first row block whose boundary check abandoned
    pair ``p`` (``n_blocks - 1`` for survivors).  One definition serves
    ``dtw_band_blocked`` and ``dtw_band_death_blocks``."""
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
    n_blocks = -(-D // R)
    death = torch.full((P,), n_blocks - 1, dtype=torch.int32, device=dev)
    found = torch.zeros((P,), dtype=torch.bool, device=dev)
    a2p, b2p = _pack(a, b, wb)
    kk = torch.arange(Wb, device=dev)
    d1 = torch.full((P, Wb), _INF, dtype=dt, device=dev)
    d2 = d1.clone()
    for d in range(D):
        nd, d1 = band_step(d, (d1, d2), a2p, b2p, kk, L=L, w=wb)
        if (d + 1) % R == 0 or d == D - 1:
            fmin = torch.minimum(nd, d1).amin(dim=-1, keepdim=True)
            dead = fmin > cut
            death = torch.where(dead[:, 0] & ~found, d // R, death)
            found = found | dead[:, 0]
            nd = torch.where(dead, _INF, nd)
            d1 = torch.where(dead, _INF, d1)
        d1, d2 = nd, d1
    return d1[:, wb], death


def dtw_band_blocked(a: Tensor, b: Tensor, w: int | None = None,
                     cutoff: Tensor | float | None = None, *,
                     row_block: int | None = None) -> Tensor:
    """Batched band-packed DTW ``(P, L) x (P, L) -> (P,)`` with the
    row-block abandon checks (module docstring).

    ``cutoff`` is a per-pair ``(P,)`` threshold or a scalar; ``None``
    never abandons.  Below its cutoff a pair's value is exact.
    """
    return _band_blocked_scan(a, b, w, cutoff, row_block)[0]


def dtw_band_death_blocks(a: Tensor, b: Tensor, w: int | None = None,
                          cutoff: Tensor | float | None = None, *,
                          row_block: int | None = None) -> Tensor:
    """``(P,)`` int32 index of the first row block whose boundary check
    abandons each pair (``n_blocks - 1`` for pairs that never abandon):
    the blocks after it are the ones an early-exit kernel skips."""
    return _band_blocked_scan(a, b, w, cutoff, row_block)[1]


def tile_skip_rate(death_blocks, n_blocks: int, tile_p: int) -> float:
    """Fraction of (pair tile, row block) cells an early-exit grid skips,
    given per-pair death blocks in packed order: a tile runs blocks
    ``0..max(death over its pairs)``; pad pairs of a short last tile die
    at block 0, so they never hold a tile open."""
    death = torch.as_tensor(death_blocks).to(torch.int64).flatten()
    pad = (-death.shape[0]) % tile_p
    if pad:
        death = torch.cat([death, death.new_zeros(pad)])
    last = death.reshape(-1, tile_p).amax(dim=1)
    skipped = int((n_blocks - 1 - last).sum())
    return float(skipped) / float(last.shape[0] * n_blocks)


def dtw(a: Tensor, b: Tensor, w: int | None = None,
        cutoff: float | None = None) -> Tensor:
    """Scalar ``DTW_w(a, b)`` of two ``(L,)`` series, abandon tested at
    every step (the JAX scalar ``dtw``'s rule): exact below ``cutoff``,
    ``+inf`` once the frontier minimum passes it."""
    return dtw_band_blocked(a[None], b[None], w, cutoff, row_block=1)[0]


def dtw_batch(a: Tensor, b: Tensor, w: int | None = None) -> Tensor:
    """Batched ``DTW_w`` over broadcast leading axes:
    ``(..., L) x (..., L) -> (...)``."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    L = a.shape[-1]
    a2 = a.expand(*shape, L).reshape(-1, L)
    b2 = b.expand(*shape, L).reshape(-1, L)
    return dtw_band_blocked(a2, b2, w, row_block=1).reshape(shape)


def dtw_pairs(q: Tensor, c: Tensor, w: int | None = None) -> Tensor:
    """All-pairs ``DTW_w``: ``(Q, L) x (C, L) -> (Q, C)``."""
    Q, C = q.shape[0], c.shape[0]
    return dtw_band_blocked(q.repeat_interleave(C, dim=0), c.repeat(Q, 1),
                            w, row_block=1).reshape(Q, C)


def cost_matrix(a: Tensor, b: Tensor, w: int | None = None) -> Tensor:
    """Full ``(L, L)`` DP matrix ``D`` (``+inf`` outside the band), for
    debugging and figures: the band-packed sweep's anti-diagonals
    scattered back to ``(i, j)``, so ``D[L-1, L-1] == dtw(a, b, w)``."""
    L = a.shape[-1]
    wb = _band_width(L, w)
    Wb = 2 * wb + 1
    a2p, b2p = _pack(a[None], b[None], wb)
    kk = torch.arange(Wb, device=a.device)
    out = torch.full((L, L), _INF, dtype=a.dtype, device=a.device)
    d1 = torch.full((1, Wb), _INF, dtype=a.dtype, device=a.device)
    d2 = d1.clone()
    for d in range(2 * L - 1):
        nd, d1 = band_step(d, (d1, d2), a2p, b2p, kk, L=L, w=wb)
        i2 = d + kk - wb                               # 2i
        j2 = d - kk + wb                               # 2j
        ok = ((i2 & 1) == 0) & (i2 >= 0) & (i2 <= 2 * L - 2) \
            & (j2 >= 0) & (j2 <= 2 * L - 2)
        out[i2[ok] // 2, j2[ok] // 2] = nd[0, ok]
        d1, d2 = nd, d1
    return out


def dtw_envelope_bound_gap(a: Tensor, b: Tensor, lb: Tensor,
                           w: int | None = None) -> Tensor:
    """Tightness ``lb / DTW_w(a, b)`` (paper Eq. 15), 1 where the DTW is
    0, for diagnostics."""
    d = dtw(a, b, w)
    return torch.where(d > 0, lb / d, 1.0)
