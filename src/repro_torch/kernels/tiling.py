"""Pair-packing permutation shared by the DTW op and its plain version.

Which pairs share a launch's neighbouring blocks is a scheduling decision
(the engine's bound-ordered schedule sorts each round by bound); the
mechanism lives here: gather the operand rows by ``perm`` before the
call, scatter the outputs back after.  Per-pair results do not depend on
the packing, so the permutation never changes a result.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def permute_pairs(perm: Tensor, *arrays):
    """Gather each array's pair axis (axis 0) by ``perm``; ``None`` entries
    pass through (an absent per-pair operand, e.g. a missing cutoff)."""
    return tuple(None if x is None else x[perm] for x in arrays)


def unpermute_pairs(perm: Tensor, out: Tensor) -> Tensor:
    """Scatter a packed output back to pre-``perm`` order:
    ``result[perm[i]] = out[i]``."""
    res = torch.empty_like(out)
    res[perm] = out
    return res


def apply_pair_perm(fn, perm: Tensor, a: Tensor, b: Tensor,
                    cutoff) -> Tensor:
    """The whole perm round trip for a pair-batched call: broadcast a
    scalar cutoff to per-pair, gather, run ``fn(a, b, cutoff)``, scatter
    the output back."""
    if cutoff is not None:
        cutoff = torch.as_tensor(cutoff, dtype=a.dtype, device=a.device)
        cutoff = cutoff.expand(a.shape[0])
    pa, pb, pcut = permute_pairs(perm, a, b, cutoff)
    return unpermute_pairs(perm, fn(pa, pb, pcut))
