"""Gradient compression with error feedback (port of
``repro.distributed.compression``).

int8 per-tensor-scaled fake quantisation applied to gradients before the
optimizer, with local error feedback so the quantisation noise is
unbiased over steps (1-bit-Adam/EF-SGD family): compressed + error ==
original (+ previous error).  Leaves under ``min_size`` elements pass
through in f32 with zero error.  A ``Stacked`` leaf (the reference's
layout of per-layer tensors, ``repro_torch.tree``) is one tensor here,
as in the reference: one scale over all its layers, and its size against
``min_size``; its compressed gradient comes back ``Stacked`` and its
error as the stacked tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.tree import Stacked, tree_map

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    bits: int = 8
    error_feedback: bool = True
    min_size: int = 4096    # don't quantise small leaves (norms, biases)


def _quantize(g: Tensor, bits: int) -> Tensor:
    """Fake-quantise to ``bits`` with a per-tensor symmetric scale
    (``torch.round`` rounds half to even, as ``jnp.round`` does)."""
    qmax = 2.0 ** (bits - 1) - 1
    scale = torch.clamp(g.abs().max(), min=1e-12) / qmax
    q = torch.clamp(torch.round(g / scale), -qmax, qmax)
    return q * scale


def compress_grads(grads: Any, err: Any | None,
                   cfg: CompressionConfig) -> tuple[Any, Any | None]:
    """Returns (compressed grads, new error state or None); the inputs are
    not modified."""

    def one(g, e=None):
        stacked = isinstance(g, Stacked)
        g32 = (g.stack() if stacked else g).float()
        if g32.numel() < cfg.min_size:
            q, new_e = g32, torch.zeros_like(g32)
        else:
            target = g32 + e if e is not None else g32 + 0.0
            q = _quantize(target, cfg.bits)
            new_e = target - q
        return (Stacked(list(q.unbind(0))) if stacked else q), new_e

    outs = (tree_map(one, grads) if err is None
            else tree_map(one, grads, err))
    pair = lambda o: isinstance(o, tuple)  # noqa: E731
    comp = tree_map(lambda o: o[0], outs, is_leaf=pair)
    new_err = tree_map(lambda o: o[1], outs, is_leaf=pair)
    return comp, (new_err if cfg.error_feedback else None)
