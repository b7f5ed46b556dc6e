"""Pointwise and pairwise distance primitives (port of
``repro.core.distances``).

The per-link cost is ``delta(a, b) = (a - b)^2`` and DTW values and lower
bounds are sums of squared differences, with no square root.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def delta(a: Tensor, b: Tensor) -> Tensor:
    """Per-link cost ``(a - b)^2``."""
    d = a - b
    return d * d


def znorm(x: Tensor, dim: int = -1, eps: float = 1e-8) -> Tensor:
    """Z-normalise along ``dim`` (population standard deviation, as
    ``jnp.std``)."""
    mu = x.mean(dim=dim, keepdim=True)
    sd = x.std(dim=dim, keepdim=True, correction=0)
    return (x - mu) / (sd + eps)


def squared_euclidean(a: Tensor, b: Tensor) -> Tensor:
    """Squared Euclidean distance between equal-length series along the
    last axis: ``DTW_0(a, b)``, the window-0 special case of DTW."""
    return delta(a, b).sum(dim=-1)


def squared_euclidean_matrix(q: Tensor, c: Tensor) -> Tensor:
    """All-pairs squared Euclidean distances ``(Q, L) x (C, L) -> (Q, C)``
    through ``|q|^2 + |c|^2 - 2 q c^T``, clamped at 0 (the factorisation
    can round a tiny distance below zero)."""
    qq = (q * q).sum(dim=-1)[:, None]
    cc = (c * c).sum(dim=-1)[None, :]
    return torch.clamp(qq + cc - 2.0 * (q @ c.T), min=0.0)
