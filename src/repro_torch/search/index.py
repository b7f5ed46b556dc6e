"""Candidate-store index for lower-bounded NN-DTW search (port of
``repro.search.index``).

The index holds everything that depends only on the store and the window
``w``: the z-normalised series (optional), the Sakoe-Chiba envelopes
(kernel K1) and the O(1) Kim features.  This system has no weights: the
index is its state, and ``index_from_numpy`` carries a JAX index across.

This slice builds the index without the int8 sketch store, plan
calibration or the store-level candidate mask (``sketch=None``,
``calibrate=None``, ``mask=False``); ROADMAP Queue 1 items 9-10 port them.
"""

from __future__ import annotations

import dataclasses
import warnings

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
    """

    series: Tensor
    labels: Tensor
    upper: Tensor
    lower: Tensor
    kim: Tensor
    kim_ok: Tensor
    w: int

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


class HygieneWarning(UserWarning):
    """Input values were masked by ``validate_series(sanitize=True)``."""


@dataclasses.dataclass(frozen=True)
class HygieneReport:
    """What input hygiene found (plain ints)."""

    bad_values: int = 0
    bad_series: int = 0
    flat_series: int = 0

    def any(self) -> bool:
        return bool(self.bad_values or self.flat_series)


def validate_series(x: Tensor, *, name: str = "series",
                    sanitize: bool = False,
                    check_flat: bool = False) -> tuple[Tensor, HygieneReport]:
    """Reject or sanitize NaN/Inf values and zero-variance series (the
    port's copy of ``repro.search.guards.validate_series``).

    Without ``sanitize`` a non-finite value (or, with ``check_flat``, a
    zero-variance row) raises ``ValueError``.  With it, non-finite values
    are masked to their row's finite mean (0.0 when none is finite), flat
    rows are kept, and a ``HygieneWarning`` reports the counts.  The clean
    path costs one reduction and one host sync, and no copy.
    """
    bad = ~torch.isfinite(x)
    flat = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    if check_flat and x.dim() > 1 and x.shape[-1] > 0:
        span = x.amax(-1) - x.amin(-1)
        flat = torch.isfinite(span) & (span == 0.0)
    bad_rows = bad.any(-1) if x.dim() > 1 else bad
    report = HygieneReport(*torch.stack(
        [bad.sum(), bad_rows.sum(), flat.sum()]).tolist())
    if not report.any():
        return x, report
    first_bad = torch.nonzero(bad_rows).flatten()[:8].tolist()
    first_flat = torch.nonzero(flat).flatten()[:8].tolist()
    if not sanitize:
        msgs = []
        if report.bad_values:
            msgs.append(f"{report.bad_values} non-finite values in "
                        f"{report.bad_series} {name} rows (first: "
                        f"{first_bad})")
        if report.flat_series:
            msgs.append(f"{report.flat_series} zero-variance {name} rows "
                        f"(first: {first_flat}) — z-norm would map these "
                        "to all-zeros")
        raise ValueError("; ".join(msgs)
                         + "; pass sanitize=True to mask and report instead")
    if report.bad_values:
        fill = torch.nanmean(torch.where(bad, float("nan"), x), dim=-1,
                             keepdim=True)
        fill = torch.where(torch.isfinite(fill), fill, 0.0)
        x = torch.where(bad, fill.expand_as(x), x)
    warnings.warn(
        f"sanitized {name}: masked {report.bad_values} non-finite values "
        f"in {report.bad_series} rows"
        + (f", {report.flat_series} zero-variance rows kept (z-norm maps "
           "them to zeros)" if report.flat_series else ""),
        HygieneWarning, stacklevel=2)
    return x, report


def build_index(series, w: int, labels=None, *, device=None,
                normalize: bool = False, sanitize: bool = False,
                sketch: int | None = None, calibrate=None,
                mask: bool = False) -> DTWIndex:
    """Build a ``DTWIndex`` for window ``w`` on ``device``.

    ``device=None`` means ``"cuda"`` and raises when no card is present;
    pass ``device="cpu"`` for the plain PyTorch path.  A store holding
    NaN/Inf raises unless ``sanitize=True`` (``validate_series``); with
    ``normalize=True`` zero-variance rows raise too, and the store is
    z-normalised.  ``sketch``, ``calibrate`` and ``mask`` are the JAX
    package's sketch tier, plan calibration and store mask, which this
    port does not have yet: anything but their off values raises.
    """
    if sketch is not None or calibrate is not None or mask:
        raise NotImplementedError(
            "build_index: the sketch store, plan calibration and the store "
            "mask are not ported yet (ROADMAP Queue 1 items 9-10); use "
            "sketch=None, calibrate=None, mask=False")
    dev = resolve_device(device)
    series = torch.as_tensor(series, dtype=torch.float32, device=dev)
    if series.dim() != 2:
        raise ValueError(f"series: expected (N, L), got "
                         f"{tuple(series.shape)}")
    series, _ = validate_series(series, name="series", sanitize=sanitize,
                                check_flat=normalize)
    if normalize:
        series = znorm(series)
    series = series.contiguous()
    if labels is None:
        labels = torch.full((series.shape[0],), -1, dtype=torch.int32,
                            device=dev)
    labels = torch.as_tensor(labels, dtype=torch.int32, device=dev)
    u, lo = envelope_op(series, w)
    kim, kim_ok = kim_features(series)
    return DTWIndex(series=series, labels=labels, upper=u, lower=lo,
                    kim=kim, kim_ok=kim_ok, w=w)


def index_from_numpy(arrays: dict, w: int, *, device) -> DTWIndex:
    """A ``DTWIndex`` from another index's fields given as numpy arrays
    (``series``, ``labels``, ``upper``, ``lower``, ``kim``, ``kim_ok``):
    the state a JAX ``repro.search.DTWIndex`` carries across, taken as it
    is, with nothing recomputed."""
    dev = resolve_device(device)

    def put(key, dtype):
        return torch.as_tensor(np.array(arrays[key]),
                               device=dev).to(dtype)

    return DTWIndex(series=put("series", torch.float32),
                    labels=put("labels", torch.int32),
                    upper=put("upper", torch.float32),
                    lower=put("lower", torch.float32),
                    kim=put("kim", torch.float32),
                    kim_ok=put("kim_ok", torch.bool), w=int(w))
