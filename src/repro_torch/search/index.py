"""Candidate-store index for lower-bounded NN-DTW search (port of
``repro.search.index``).

The index holds everything that depends only on the store and the window
``w``: the z-normalised series (optional), the Sakoe-Chiba envelopes
(kernel K1) and the O(1) Kim features.  This system has no weights: the
index is its state, and ``index_from_numpy`` carries a JAX index across.

Sketch store (tier -1, kernel K7): the length axis is split into ``S``
segments (``b[j] = j * L // S``), each envelope's segment means are
quantised outward onto one symmetric int8 grid,

    sk_hi[n, j] = ceil(mean(upper[n, b[j]:b[j+1]]) / scale)
    sk_lo[n, j] = floor(mean(lower[n, b[j]:b[j+1]]) / scale)
    sk_scale    = max |segment mean| / 127 * (1 + 1e-6)

and the bound is the segment-reduced LB_Keogh
``sum_j n_j * max(qbar_j - hi_j * scale, lo_j * scale - qbar_j, 0)^2 <=
LB_Keogh <= DTW_w``, 2 S = 32 bytes per candidate at S = 16.

Store-level mask (``build_index(calibrate=cfg, mask=True)``): candidates
whose sketch bound exceeds every calibration query's seed threshold
(times ``mask_safety``) are marked dead in ``live``; masked tiers return
``-inf`` for them while the unmasked cheap tiers keep a valid bound, so
the mask removes work, never a neighbour.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.distances import znorm
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import envelope_op

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class DTWIndex:
    """Immutable candidate store and per-candidate precomputation.

    Attributes:
      series: (N, L) float32 candidate series.
      labels: (N,) int32 labels (-1 when unlabelled).
      upper:  (N, L) upper envelopes for window ``w``.
      lower:  (N, L) lower envelopes.
      kim:    (N, 4) [first, last, max, min] Kim features.
      kim_ok: (N, 2) bool [max interior, min interior] witness flags.
      w:      the window the envelopes were built for.
      sk_lo / sk_hi: (N, S) int8 outward-quantised segment means of the
              lower / upper envelope (``None`` without a sketch).
      sk_scale: () f32 dequantisation scale of the sketch.
      live:   (N,) bool store-level candidate mask (``None``: all live).

    Instances hash and compare by identity, so the plan and budget memos
    can key on an index and hold it by weak reference.
    """

    series: Tensor
    labels: Tensor
    upper: Tensor
    lower: Tensor
    kim: Tensor
    kim_ok: Tensor
    w: int
    sk_lo: Tensor | None = None
    sk_hi: Tensor | None = None
    sk_scale: Tensor | None = None
    live: Tensor | None = None

    @property
    def n(self) -> int:
        return self.series.shape[0]

    @property
    def length(self) -> int:
        return self.series.shape[1]

    @property
    def device(self) -> torch.device:
        return self.series.device


def kim_features(x: Tensor) -> tuple[Tensor, Tensor]:
    """Per-series Kim features and interior-witness flags (see
    ``core.lower_bounds.lb_kim``); the first extremum wins ties."""
    L = x.shape[-1]
    imax = x.argmax(-1)
    imin = x.argmin(-1)
    feats = torch.stack([x[..., 0], x[..., -1], x.amax(-1), x.amin(-1)],
                        dim=-1)
    ok = torch.stack([(imax != 0) & (imax != L - 1),
                      (imin != 0) & (imin != L - 1)], dim=-1)
    return feats, ok


def sketch_segments(L: int, s: int) -> tuple[tuple[int, int], ...]:
    """Segment boundaries ``b[j] = j * L // s`` as (start, stop) pairs;
    ``s`` halves while it exceeds ``L``, so no segment is empty."""
    s = max(1, int(s))
    while s > L:
        s //= 2
    bounds = [j * L // s for j in range(s + 1)]
    return tuple((bounds[j], bounds[j + 1]) for j in range(s))


def sketch_segment_sizes(L: int, s: int, device=None) -> Tensor:
    """``(S,)`` f32 segment lengths ``n_j`` (the bound's weights)."""
    return torch.tensor([b - a for a, b in sketch_segments(L, s)],
                        dtype=torch.float32, device=device)


def sketch_query_means(q: Tensor, s: int) -> Tensor:
    """Per-segment f32 means ``(..., L) -> (..., S)`` (of a query batch,
    or of the envelopes for ``sketch_features``), in one fixed order: each
    segment summed left to right, then multiplied by the f32 reciprocal
    of its length, the order XLA gives ``jnp.mean`` on the CPU.  The sum
    runs over the segment offset ``t`` for all segments at once, so the
    value does not depend on the device."""
    segs = sketch_segments(q.shape[-1], s)
    starts = torch.tensor([a for a, _ in segs], device=q.device)
    sizes = torch.tensor([b - a for a, b in segs], device=q.device)
    acc = torch.zeros(q.shape[:-1] + (len(segs),), dtype=torch.float32,
                      device=q.device)
    for t in range(int(sizes.max())):
        cols = torch.clamp(starts + t, max=q.shape[-1] - 1)
        acc = acc + torch.where(t < sizes, q[..., cols], 0.0)
    recip = torch.tensor([1.0 / (b - a) for a, b in segs],
                         dtype=torch.float32, device=q.device)
    return acc * recip


def sketch_features(upper: Tensor, lower: Tensor,
                    s: int = 16) -> tuple[Tensor, Tensor, Tensor]:
    """Quantise ``(N, L)`` envelopes into the int8 sketch store
    ``(sk_lo, sk_hi, sk_scale)`` with outward rounding (module
    docstring): ``sk_hi * scale >= mean(upper)`` and ``sk_lo * scale <=
    mean(lower)`` cell by cell."""
    useg = sketch_query_means(upper, s)
    lseg = sketch_query_means(lower, s)
    if useg.numel():
        maxabs = torch.maximum(useg.abs().amax(), lseg.abs().amax())
    else:
        maxabs = torch.zeros((), device=upper.device)
    # 1e-6 headroom: |cell / scale| < 127 strictly, so the clip can never
    # pull a ceil'd or floor'd cell back inward
    scale = (torch.where(maxabs > 0.0, maxabs, 1.0)
             * ((1.0 + 1e-6) / 127.0))
    sk_hi = torch.clamp(torch.ceil(useg / scale), -127, 127).to(torch.int8)
    sk_lo = torch.clamp(torch.floor(lseg / scale), -127, 127).to(torch.int8)
    from repro_torch.search.guards import fault_hook

    hook = fault_hook("sketch_feats")
    if hook is not None:
        sk_lo, sk_hi = hook(sk_lo, sk_hi)
    return sk_lo.contiguous(), sk_hi.contiguous(), scale.to(torch.float32)


def build_index(series, w: int, labels=None, *, device=None,
                normalize: bool = False, sanitize: bool = False,
                preflight: bool = False, calibrate=None,
                calibrate_sample: int = 8, sketch: int | None = 16,
                mask: bool = False, mask_safety: float = 2.0) -> DTWIndex:
    """Build a ``DTWIndex`` for window ``w`` on ``device``.

    ``device=None`` means ``"cuda"`` and raises when no card is present;
    pass ``device="cpu"`` for the plain PyTorch path.  A store holding
    NaN/Inf raises unless ``sanitize=True`` (``guards.validate_series``);
    with ``normalize=True`` zero-variance rows raise too, and the store is
    z-normalised.  ``preflight`` runs ``guards.preflight_engine`` on the
    index's device first.

    ``sketch`` is the segment count S of the int8 sketch store (``None``
    builds none; the sketch tier then scores zeros).  ``calibrate`` (an
    ``EngineConfig`` or ``CascadeConfig``) commits the planner's plan for
    this store at build time from a leave-one-out search of
    ``calibrate_sample`` strided store series (search/planner.py).
    ``mask=True`` (with ``calibrate`` and a sketch) first derives the
    store ``live`` mask from that sample: a candidate stays live when its
    sketch bound is within ``mask_safety`` times some sampled query's
    seed threshold.
    """
    dev = resolve_device(device)
    series = torch.as_tensor(series, dtype=torch.float32, device=dev)
    if series.dim() != 2:
        raise ValueError(f"series: expected (N, L), got "
                         f"{tuple(series.shape)}")
    from repro_torch.search import guards as _guards

    series, _ = _guards.validate_series(series, name="series",
                                        sanitize=sanitize,
                                        check_flat=normalize)
    if preflight:
        _guards.preflight_engine(dev)
    if normalize:
        series = znorm(series)
    series = series.contiguous()
    if labels is None:
        labels = torch.full((series.shape[0],), -1, dtype=torch.int32,
                            device=dev)
    labels = torch.as_tensor(labels, dtype=torch.int32, device=dev)
    u, lo = envelope_op(series, w)
    kim, kim_ok = kim_features(series)
    sk_lo = sk_hi = sk_scale = None
    if sketch is not None:
        sk_lo, sk_hi, sk_scale = sketch_features(u, lo, sketch)
    index = DTWIndex(series=series, labels=labels, upper=u, lower=lo,
                     kim=kim, kim_ok=kim_ok, w=w, sk_lo=sk_lo, sk_hi=sk_hi,
                     sk_scale=sk_scale)
    if calibrate is not None:
        from repro_torch.search.planner import (calibrate_plan,
                                                calibration_sample)

        cascade = getattr(calibrate, "cascade", calibrate)
        k = int(getattr(calibrate, "k", 1))
        if cascade.staged:
            # strided store sample: a class-ordered store gets every
            # class into the measurement
            pick = calibration_sample(index.n, calibrate_sample)
            pick_t = torch.as_tensor(pick, device=dev)
            if mask and index.sk_lo is not None:
                index = _derive_live_mask(index, cascade, k, pick_t,
                                          mask_safety)
            calibrate_plan(index.series[pick_t], index, cascade, k,
                           exclude=pick_t, sample=len(pick),
                           pcfg=getattr(calibrate, "planner", None))
    return index


def _derive_live_mask(index: DTWIndex, cascade, k: int, pick: Tensor,
                      mask_safety: float) -> DTWIndex:
    """Leave-one-out store mask: run the cascade on the calibration
    sample for the seed thresholds ``tau_i`` (each an upper bound on
    query i's k-th NN distance), then keep a candidate live when its
    sketch bound (through ``ops.sketch_bound_op``: kernel K7 on the card)
    is at most ``tau_i * mask_safety + 1e-6`` for some sampled ``i``."""
    from repro_torch.kernels.ops import sketch_bound_op
    from repro_torch.search.cascade import run_plan

    qs = index.series[pick]
    cres = run_plan(qs, index, cascade, k=k, exclude=pick)
    tau = torch.where(torch.isfinite(cres.seed_d), cres.seed_d,
                      0.0).amax(dim=1)
    s = index.sk_lo.shape[1]
    sb = sketch_bound_op(sketch_query_means(qs, s), index.sk_lo,
                         index.sk_hi, index.sk_scale,
                         sketch_segment_sizes(index.length, s,
                                              device=qs.device))
    live = (sb <= tau[:, None] * mask_safety + 1e-6).any(dim=0)
    return dataclasses.replace(index, live=live)


_FIELDS = (("series", torch.float32), ("labels", torch.int32),
           ("upper", torch.float32), ("lower", torch.float32),
           ("kim", torch.float32), ("kim_ok", torch.bool),
           ("sk_lo", torch.int8), ("sk_hi", torch.int8),
           ("sk_scale", torch.float32), ("live", torch.bool))


def index_from_numpy(arrays: dict, w: int, *, device) -> DTWIndex:
    """A ``DTWIndex`` from another index's fields given as numpy arrays
    (``series``, ``labels``, ``upper``, ``lower``, ``kim``, ``kim_ok`` and,
    where present and not ``None``, ``sk_lo``, ``sk_hi``, ``sk_scale``,
    ``live``): the state a JAX ``repro.search.DTWIndex`` carries across,
    taken as it is, with nothing recomputed."""
    dev = resolve_device(device)
    fields = {}
    for key, dtype in _FIELDS:
        if arrays.get(key) is not None:
            fields[key] = torch.as_tensor(np.array(arrays[key]),
                                          device=dev).to(dtype)
    return DTWIndex(w=int(w), **fields)
