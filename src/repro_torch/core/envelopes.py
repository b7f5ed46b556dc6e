"""Sakoe-Chiba window envelopes (paper Eqs. 5-6), plain PyTorch.

``U_i = max_{|j - i| <= w} B_j`` and ``L_i = min_{|j - i| <= w} B_j``,
computed with prefix-doubling shifted reductions (O(L log w) dense ops),
as ``repro.core.envelopes`` does.  Max and min are exact, so any
evaluation order gives the same values: this is the plain version the
envelope kernel (kernels/envelope.py) is held to bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_INF = float("inf")


def _shift_left(x: Tensor, s: int, fill: float) -> Tensor:
    """``y[..., i] = x[..., i + s]``, positions past the end filled."""
    if s == 0:
        return x
    return F.pad(x[..., s:], (0, s), value=fill)


def sliding_reduce(x: Tensor, k: int, op, fill: float) -> Tensor:
    """``y[..., i] = op-reduction of x[..., i : i + k]`` (clipped at the
    end), in O(log k) shifted ops."""
    if k <= 1:
        return x
    m = x
    p = 1
    while p * 2 <= k:
        m = op(m, _shift_left(m, p, fill))
        p *= 2
    if p < k:
        # [i, i+p) and [i+k-p, i+k) cover [i, i+k) since k - p <= p
        m = op(m, _shift_left(m, k - p, fill))
    return m


def envelope(b: Tensor, w: int) -> tuple[Tensor, Tensor]:
    """Upper/lower envelopes of ``(..., L)`` series for half-width ``w``."""
    if w == 0:
        return b, b
    L = b.shape[-1]
    k = 2 * w + 1
    bu = F.pad(b, (w, 0), value=-_INF)
    bl = F.pad(b, (w, 0), value=_INF)
    u = sliding_reduce(bu, k, torch.maximum, -_INF)[..., :L]
    lo = sliding_reduce(bl, k, torch.minimum, _INF)[..., :L]
    return u.contiguous(), lo.contiguous()


def envelope_naive(b: Tensor, w: int) -> tuple[Tensor, Tensor]:
    """O(L w) envelopes by explicit window gathers, an oracle for
    ``envelope``: the window of position i is ``[i - w, i + w]`` clipped
    to the series."""
    L = b.shape[-1]
    idx = (torch.arange(L, device=b.device)[:, None]
           + torch.arange(-w, w + 1, device=b.device)[None, :])
    valid = (idx >= 0) & (idx < L)
    vals = b[..., idx.clamp(0, L - 1)]                   # (..., L, 2w+1)
    u = torch.where(valid, vals, -_INF).amax(dim=-1)
    lo = torch.where(valid, vals, _INF).amin(dim=-1)
    return u, lo
