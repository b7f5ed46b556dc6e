"""Deterministic fault injectors: each one trips the guard built for it
(port of ``repro.testing.faults``).

``inject(name, fn)`` installs ``fn`` at seam ``name`` of
``search/guards.py``'s ``_FAULT_HOOKS`` for the duration of a ``with``
block.  The seams and their hooks:

  ``tier_out``         (t, tier_name) -> t          a bound tier's output
  ``compaction_cand``  (cand) -> cand               the compaction's pick
  ``packed_rows``      (crows, urows, lrows) -> same   packed survivors
  ``dtw_out``          (d) -> d                     kernels/ops.py DTW
  ``engine_count``     (seg) -> seg                 a round's n_dtw increments
  ``sketch_feats``     (sk_lo, sk_hi) -> same       build-time quantiser
  ``allgather_topk``   (d_all) -> d_all             distributed top-k gather

Every injector is deterministic (fixed rows and scales, no random
numbers), so a tripped guard reproduces exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.search import guards as _guards


@contextlib.contextmanager
def inject(name: str, fn: Callable) -> Iterator[None]:
    """Install ``fn`` at seam ``name`` for the block; re-entering the same
    seam raises (a shadowed injector would make a trip test vacuous)."""
    if name in _guards._FAULT_HOOKS:
        raise RuntimeError(f"fault seam {name!r} already injected")
    _guards._FAULT_HOOKS[name] = fn
    try:
        yield
    finally:
        _guards._FAULT_HOOKS.pop(name, None)


# ---------------------------------------------------------------------------
# input corruption
# ---------------------------------------------------------------------------


def corrupt_series(x, rows=(0,), cols=(0,), value: float = np.nan):
    """A copy of a ``(N, L)`` array with fixed positions set to ``value``
    (NaN/Inf): the hygiene boundary must reject or sanitize it."""
    arr = np.array(x, np.float32, copy=True)
    for r in rows:
        for c in cols:
            arr[r, c] = value
    return arr


def poison_envelopes(index, rows=(0,), value: float = np.nan):
    """A copy of a ``DTWIndex`` whose envelope rows are ``value``: the
    bound tiers emit non-finite bounds that the finite gate must
    contain."""
    upper = index.upper.clone()
    lower = index.lower.clone()
    r = torch.as_tensor(rows, device=upper.device)
    upper[r] = value
    lower[r] = value
    return dataclasses.replace(index, upper=upper, lower=lower)


# ---------------------------------------------------------------------------
# seam injectors (context managers)
# ---------------------------------------------------------------------------


def inadmissible_tier(tier: str = "bands", scale: float = 4.0,
                      shift: float = 1.0):
    """One tier lies upward, ``LB -> LB * scale + shift`` on its finite
    values: the admissibility guard must trip."""

    def hook(t, name):
        if name != tier:
            return t
        return torch.where(torch.isfinite(t), t * scale + shift, t)

    return inject("tier_out", hook)


def nonfinite_tier(tier: str = "bands", value: float = np.nan):
    """One tier's output replaced by NaN/Inf: the finite gate must count
    and contain it."""

    def hook(t, name):
        return torch.full_like(t, value) if name == tier else t

    return inject("tier_out", hook)


def drop_compaction_candidates(n_dup: int = 1):
    """The last ``n_dup`` compacted columns repeat the first one, so
    ``n_dup`` survivors are lost from the pack: the conservation guard
    must trip."""

    def hook(cand):
        cand = cand.clone()
        cand[:, -n_dup:] = cand[:, :1]
        return cand

    return inject("compaction_cand", hook)


def corrupt_packed_rows(value: float = np.nan, rows: int = 1):
    """The first ``rows`` packed survivor rows set to ``value``: the
    finite gate on the pairwise tiers must contain it."""

    def hook(crows, urows, lrows):
        out = []
        for x in (crows, urows, lrows):
            x = x.clone()
            x[:rows] = value
            out.append(x)
        return tuple(out)

    return inject("packed_rows", hook)


def corrupt_dtw(scale: float | None = 0.05, value: float | None = None):
    """Corrupt the DTW op's finite outputs (kernels/ops.py seam): shrunk
    by ``scale`` (they fall below valid bounds, admissibility trips) or
    overwritten by ``value`` (NaN: the NaN-DTW guard trips).  The
    degradation rerun's plain DTW does not pass this seam."""

    def hook(d):
        fin = torch.isfinite(d)
        if value is not None:
            return torch.where(fin, torch.full_like(d, value), d)
        return torch.where(fin, d * scale, d)

    return inject("dtw_out", hook)


def miscount_verifications(delta: int = 1):
    """Add ``delta`` to query 0's per-round ``n_dtw`` increment: the
    accounting guard must trip."""

    def hook(seg):
        seg = seg.clone()
        seg[0] += delta
        return seg

    return inject("engine_count", hook)


def inward_quantiser(steps: int = 96):
    """Pull the stored sketch envelope inward by ``steps`` int8 steps on
    both sides, breaking the outward-rounding invariant that makes the
    sketch bound admissible: a search with the sketch tier must trip
    admissibility and degrade.  A build-time fault: inject it around
    ``build_index``."""

    def hook(sk_lo, sk_hi):
        lo = torch.clamp(sk_lo.to(torch.int32) + steps, -127, 127)
        hi = torch.clamp(sk_hi.to(torch.int32) - steps, -127, 127)
        return lo.to(torch.int8), hi.to(torch.int8)

    return inject("sketch_feats", hook)


def shard_dropout(shard: int = 0):
    """A dead shard in the distributed top-k merge: shard ``shard``'s
    all-gathered distances come back ``+inf`` on every rank (its
    candidates vanish from every merge).  The step's echo check (each
    shard must find its own top-k intact in the gather) trips conservation
    on the dropped shard."""

    def hook(d_all):
        d_all = d_all.clone()
        d_all[shard] = float("inf")
        return d_all

    return inject("allgather_topk", hook)
