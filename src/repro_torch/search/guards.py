"""Runtime exactness guards: invariant checks, containment, degradation
(port of ``repro.search.guards``).

Every guard counts violations into a ``GuardReport`` of float32 scalar
tensors on the search's device instead of raising, so the checks add no
host sync of their own: the engine reads the report once, after its
round loop.

  * **admissibility** (``admissibility_check``): pairs with an exact DTW
    value (the cascade's seeds, every engine round) must satisfy
    ``LB <= DTW`` within ``rtol``/``atol``;
  * **conservation** (``conservation_check``, ``scatter_monotone_check``):
    the compaction selects distinct candidates per query, and the
    scatter-max back into the bound matrix only tightens;
  * **accounting** (engine): the per-query ``n_dtw`` increments of a round
    sum to the flat count of necessary verifications, and
    ``k <= n_dtw <= N`` at the end;
  * **finite gates** (``finite_gate_bounds``, ``finite_gate_dtw``): NaN and
    ``+inf`` tier outputs become ``-inf`` (a valid bound: verify the
    candidate), NaN DTW values become ``+inf``, all counted.

Degradation ladder: (0) ``preflight_engine`` proves the engine against
brute force on a canary store; (1) the finite gates contain poisoned
values; (2) a tripped admissibility / conservation / accounting / NaN-DTW
guard makes ``nn_search`` re-serve the batch by brute force through the
plain versions (``use_kernels=False``: the kernel route is untrusted),
with a ``GuardWarning``; (3) ``validate_series`` rejects or sanitizes
NaN/Inf and zero-variance input at the boundary.

Fault-injection seams: ``testing/faults.py`` installs hooks into
``_FAULT_HOOKS``; production code does one dict lookup per seam, ``None``
outside the harness.  The seams: ``tier_out``, ``compaction_cand``,
``packed_rows`` (cascade.run_plan), ``dtw_out`` (kernels/ops.py),
``engine_count`` (engine), ``sketch_feats`` (index.sketch_features) and
``allgather_topk`` (the distributed step's top-k gather,
search/distributed.py).  The JAX package's ``preflight_shard_map`` works
around a jax 0.4 miscompile of ``jit(shard_map(while_loop))``, as does
its distributed step's ``jit=`` argument; nothing here is compiled that
way, so neither has a counterpart.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor

_INF = float("inf")


class GuardWarning(UserWarning):
    """Category of every guard, preflight and hygiene warning."""


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Which invariant checks run, and the degradation policy.

    Attributes:
      enabled: master switch; ``False`` makes every guard a no-op.
      admissibility: sampled ``LB <= DTW`` checks (seeds and rounds).
      conservation: compaction distinct-count and scatter monotonicity.
      accounting: engine ``n_dtw`` increments against the flat mirror and
        the ``k <= n_dtw <= N`` bounds.
      finite_gates: NaN/+inf tier outputs gated to -inf, NaN DTW outputs
        to +inf, both counted.
      rtol / atol: tolerance of the admissibility comparison.
      degrade: re-serve a batch by plain brute force when a trigger guard
        trips.
    """

    enabled: bool = True
    admissibility: bool = True
    conservation: bool = True
    accounting: bool = True
    finite_gates: bool = True
    rtol: float = 1e-4
    atol: float = 1e-5
    degrade: bool = True


_FORCED = GuardConfig()


def resolve_guards(cfg: GuardConfig | None) -> GuardConfig:
    """``None`` means the default-on config; ``REPRO_FORCE_GUARDS=1`` in
    the environment turns every guard on whatever the config says."""
    if os.environ.get("REPRO_FORCE_GUARDS", "") not in ("", "0"):
        return _FORCED
    return cfg if cfg is not None else GuardConfig()


_VEC_FIELDS = (
    "admiss_checked", "admiss_viol", "admiss_gap",
    "conserve_checked", "conserve_viol",
    "account_checked", "account_viol",
    "nonfinite_bounds", "nonfinite_dtw",
    "hygiene_values", "hygiene_series", "hygiene_flat",
    "degraded",
)

# counters that trip the degradation ladder when > 0; the bound gate and
# the hygiene counts report what was already contained
_TRIP_FIELDS = ("admiss_viol", "conserve_viol", "account_viol",
                "nonfinite_dtw")


def _f32(x, device=None) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class GuardReport:
    """Guard outcome of one search or executor pass: float32 scalar
    tensors, counts and ``*_checked`` totals that add under ``merge`` and
    an admissibility ``gap`` (worst ``LB - DTW`` overshoot) that maxes.
    ``to_vector`` / ``from_vector`` give the flat ``(13,)`` form."""

    admiss_checked: Tensor
    admiss_viol: Tensor
    admiss_gap: Tensor
    conserve_checked: Tensor
    conserve_viol: Tensor
    account_checked: Tensor
    account_viol: Tensor
    nonfinite_bounds: Tensor
    nonfinite_dtw: Tensor
    hygiene_values: Tensor
    hygiene_series: Tensor
    hygiene_flat: Tensor
    degraded: Tensor

    @staticmethod
    def zeros(device=None) -> "GuardReport":
        z = torch.zeros((), dtype=torch.float32, device=device)
        return GuardReport(**{f: z for f in _VEC_FIELDS})

    def merge(self, other: "GuardReport") -> "GuardReport":
        """Counts add, the admissibility gap maxes."""
        vals = {}
        for f in _VEC_FIELDS:
            a, b = getattr(self, f), getattr(other, f)
            b = _f32(b, a.device)
            vals[f] = torch.maximum(a, b) if f == "admiss_gap" else a + b
        return GuardReport(**vals)

    def to_vector(self) -> Tensor:
        return torch.stack([_f32(getattr(self, f)) for f in _VEC_FIELDS])

    @staticmethod
    def from_vector(v: Tensor) -> "GuardReport":
        return GuardReport(**{f: v[i] for i, f in enumerate(_VEC_FIELDS)})

    def values(self) -> dict[str, float]:
        """Every counter as a Python float (one host sync)."""
        return dict(zip(_VEC_FIELDS, self.to_vector().tolist()))

    def tripped(self) -> tuple[str, ...]:
        """Names of the trigger guards whose violation count is non-zero
        (host sync)."""
        g = self.values()
        return tuple(f for f in _TRIP_FIELDS if g[f] > 0)

    def ok(self) -> bool:
        return not self.tripped()

    def summary(self) -> str:
        """One-line readout (host sync)."""
        g = self.values()
        parts = [
            f"admissibility {g['admiss_viol']:.0f}/{g['admiss_checked']:.0f}"
            + (f" (gap {g['admiss_gap']:.3g})" if g["admiss_viol"] else ""),
            f"conservation {g['conserve_viol']:.0f}/"
            f"{g['conserve_checked']:.0f}",
            f"accounting {g['account_viol']:.0f}/{g['account_checked']:.0f}",
        ]
        if g["nonfinite_bounds"] + g["nonfinite_dtw"]:
            parts.append(f"gated {g['nonfinite_bounds']:.0f} bounds / "
                         f"{g['nonfinite_dtw']:.0f} dtw")
        if g["hygiene_values"] + g["hygiene_flat"]:
            parts.append(f"hygiene {g['hygiene_values']:.0f} values in "
                         f"{g['hygiene_series']:.0f} series, "
                         f"{g['hygiene_flat']:.0f} flat")
        if g["degraded"]:
            parts.append(f"degraded x{g['degraded']:.0f} (plain rerun)")
        trip = self.tripped()
        status = "TRIPPED " + ",".join(trip) if trip else "ok"
        return f"guards[{status}]: " + "   ".join(parts)


# ---------------------------------------------------------------------------
# the checks (device tensors, no host sync)
# ---------------------------------------------------------------------------


def finite_gate_bounds(t: Tensor) -> tuple[Tensor, Tensor]:
    """NaN / +inf bounds become ``-inf`` (verify the candidate); ``-inf``
    passes (the dead-slot identity).  Returns ``(gated, n_gated)``."""
    bad = torch.isnan(t) | torch.isposinf(t)
    return torch.where(bad, -_INF, t), bad.sum().to(torch.float32)


def finite_gate_dtw(d: Tensor, valid: Tensor | None = None
                    ) -> tuple[Tensor, Tensor]:
    """NaN DTW values become ``+inf`` and are counted (over ``valid``
    slots only when given); ``+inf`` passes (an abandoned pair)."""
    bad = torch.isnan(d)
    n = bad if valid is None else bad & valid
    return torch.where(bad, _INF, d), n.sum().to(torch.float32)


def verification_eligible(slb: Tensor) -> Tensor:
    """Exactly ``+inf`` marks a verified seed or an excluded candidate;
    every other sorted bound, NaN and ``-inf`` included, stays eligible
    for verification."""
    return ~torch.isposinf(slb)


def admissibility_check(lb: Tensor, d: Tensor, rtol: float, atol: float,
                        valid: Tensor | None = None
                        ) -> tuple[Tensor, Tensor, Tensor]:
    """``LB <= DTW`` on pairs where both are finite: ``(checked, viol,
    gap)``, gap the worst ``LB - DTW`` overshoot (0 when clean)."""
    fin = torch.isfinite(d) & torch.isfinite(lb)
    if valid is not None:
        fin = fin & valid
    over = torch.where(fin, lb - d, -_INF)
    viol = (fin & (lb > d * (1.0 + rtol) + atol)).sum()
    gap = torch.clamp(over.amax() if over.numel() else
                      over.new_full((), -_INF), min=0.0)
    return (fin.sum().to(torch.float32), viol.to(torch.float32),
            gap.to(torch.float32))


def conservation_check(cand: Tensor, n: int) -> tuple[Tensor, Tensor]:
    """The compaction must pick ``W`` distinct candidates per query:
    ``(checked, viol)``, one check per query."""
    Q, W = cand.shape
    marks = torch.zeros((Q, n), dtype=torch.int32, device=cand.device)
    marks.scatter_add_(1, cand, torch.ones_like(cand, dtype=torch.int32))
    distinct = (marks > 0).sum(1)
    return (_f32(float(Q), cand.device),
            (distinct != W).sum().to(torch.float32))


def scatter_monotone_check(lb_before: Tensor, lb_after: Tensor
                           ) -> tuple[Tensor, Tensor]:
    """The scatter-max may only tighten: ``lb_after >= lb_before``
    everywhere.  ``(checked, viol)``, one check per query."""
    return (_f32(float(lb_before.shape[0]), lb_before.device),
            (lb_after < lb_before).sum().to(torch.float32))


# ---------------------------------------------------------------------------
# input hygiene (degradation ladder layer 3, at the boundary)
# ---------------------------------------------------------------------------


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
    """Reject or sanitize NaN/Inf values and zero-variance series.

    Without ``sanitize`` a non-finite value (or, with ``check_flat``, a
    zero-variance row) raises ``ValueError``.  With it, non-finite values
    are masked to their row's finite mean (0.0 when none is finite), flat
    rows are kept, and a ``GuardWarning`` reports the counts.  The clean
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
        GuardWarning, stacklevel=2)
    return x, report


def hygiene_to_report(h: HygieneReport, device=None) -> GuardReport:
    """Hygiene counts as a ``GuardReport``."""
    return dataclasses.replace(
        GuardReport.zeros(device),
        hygiene_values=_f32(float(h.bad_values), device),
        hygiene_series=_f32(float(h.bad_series), device),
        hygiene_flat=_f32(float(h.flat_series), device))


# ---------------------------------------------------------------------------
# fault-injection seams (filled only by testing/faults.py)
# ---------------------------------------------------------------------------

_FAULT_HOOKS: dict[str, Callable] = {}


def fault_hook(name: str) -> Callable | None:
    """The hook installed at seam ``name``, or ``None``.  Install hooks
    with ``repro_torch.testing.faults.inject`` only."""
    return _FAULT_HOOKS.get(name)


# ---------------------------------------------------------------------------
# preflight (degradation ladder layer 0)
# ---------------------------------------------------------------------------

_PREFLIGHT_CACHE: dict = {}
_WARN_COUNTS: dict[str, int] = {}


def warn_once(key: str, message: str) -> bool:
    """Emit a ``GuardWarning`` once per process per key; ``True`` when it
    fired."""
    n = _WARN_COUNTS.get(key, 0)
    _WARN_COUNTS[key] = n + 1
    if n == 0:
        warnings.warn(message, GuardWarning, stacklevel=3)
        return True
    return False


def warn_count(key: str) -> int:
    """How many times ``warn_once(key, ...)`` was asked for."""
    return _WARN_COUNTS.get(key, 0)


def preflight_clear() -> None:
    """Drop cached preflight verdicts and warning bookkeeping."""
    _PREFLIGHT_CACHE.clear()
    _WARN_COUNTS.clear()


def preflight_engine(device=None) -> bool:
    """Self-test on a canary store: ``nn_search`` on ``device`` (``None``
    means the card, as for ``build_index``) must equal brute force through
    the plain DTW.  Cached per process and device type; on a mismatch
    warns once and returns ``False``."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    key = ("engine", torch.__version__, dev.type)
    hit = _PREFLIGHT_CACHE.get(key)
    if hit is not None:
        return hit
    from repro_torch.search.cascade import CascadeConfig
    from repro_torch.search.engine import EngineConfig, brute_force, nn_search
    from repro_torch.search.index import build_index

    rng = np.random.default_rng(0)
    series = rng.normal(size=(32, 16)).astype(np.float32)
    queries = rng.normal(size=(2, 16)).astype(np.float32)
    idx = build_index(series, 4, device=dev, sketch=None)
    cfg = EngineConfig(cascade=CascadeConfig(w=4, v=4, candidate_chunk=8),
                       verify_chunk=4, k=2)
    got = nn_search(idx, queries, cfg).dists
    want, _ = brute_force(idx, queries, 4, k=2, use_kernels=False)
    ok = bool(torch.allclose(got, want, rtol=1e-4))
    if not ok:
        warn_once("preflight_engine",
                  "preflight: the engine does not match brute force on the "
                  "canary store — keep runtime guards on and expect "
                  "degradation reruns")
    _PREFLIGHT_CACHE[key] = ok
    return ok
