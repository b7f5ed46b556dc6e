"""Pointwise distance primitives (port of ``repro.core.distances``).

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
