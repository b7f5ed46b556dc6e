"""The search system: exact 1-NN-DTW with ``repro_torch.search``.

Set-up makes the store on the device from the seed and builds the index
with ``build_index``; each batch of the window is one ``nn_search`` call
under the configuration's engine.  The judge holds the window's answers
against ``reference/nn_dtw.py``, which reads the raw store and queries.
"""

from __future__ import annotations

import dataclasses
import gc
import time
import warnings

import torch

from portbench import datagen
from portbench.probes import Probes
from portbench.reference import nn_dtw as ref
from portbench.traffic import generator as traffic


@dataclasses.dataclass
class State:
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    store: dict
    index: object = None
    engine: object = None
    index_build_s: float = 0.0
    guard_warnings: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def prepare(cfg: dict, mix: dict, seed: int, device) -> State:
    """The store on the device, then the index (timed to its last
    kernel)."""
    from repro_torch.search import (CascadeConfig, EngineConfig,
                                    build_index)

    traffic.validate(mix, cfg)
    dev = torch.device(device)
    protos, series, labels = datagen.make_store(cfg, seed, dev)
    state = State(cfg=cfg, mix=mix, seed=seed, device=dev,
                  store={"protos": protos, "series": series,
                         "labels": labels})
    w = int(mix["w"])
    _sync(dev)
    t0 = time.perf_counter()
    state.index = build_index(series, w, labels, device=dev)
    _sync(dev)
    state.index_build_s = time.perf_counter() - t0
    state.engine = EngineConfig(
        cascade=CascadeConfig(w=w, v=cfg["v"], use_kim=cfg["use_kim"],
                              use_sketch=cfg["use_sketch"],
                              candidate_chunk=cfg["candidate_chunk"],
                              staged=cfg["staged"]),
        verify_chunk=cfg["verify_chunk"], k=cfg["k"],
        auto_plan=cfg["auto_plan"])
    return state


def queries(state: State, stream: str, b: int) -> torch.Tensor:
    return traffic.batch(state.mix, state.cfg, state.store, state.seed,
                         stream, b)


def search(state: State, q: torch.Tensor):
    """One ``nn_search`` call; its answers ``(dists, ids, n_dtw)``."""
    from repro_torch.search import GuardWarning, nn_search

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", GuardWarning)
        res = nn_search(state.index, q, state.engine)
    state.guard_warnings += sum(issubclass(c.category, GuardWarning)
                                for c in caught)
    return res.dists[:, 0], res.idx[:, 0], res.n_dtw


def run_batch(state: State, stream: str, b: int) -> tuple[int, tuple]:
    q = queries(state, stream, b)
    return q.shape[0], search(state, q)


def probes(state: State) -> Probes:
    return Probes(state.device)


def counters(state: State, outputs: list) -> dict:
    """What the window's answers count: the engine's verifications."""
    n_dtw = sum(int(o[2].to(torch.int64).sum()) for o in outputs)
    return {"n_dtw": n_dtw, "guard_warnings": state.guard_warnings}


def free_program(state: State) -> None:
    """Drop the index and the engine: the reference runs after them."""
    state.index = None
    state.engine = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()


def window_queries(state: State, batches: int) -> torch.Tensor:
    """Every query of the window's ``batches`` batches, drawn again from
    their streams, in the window's order."""
    return torch.cat([queries(state, "window", b) for b in range(batches)])


def sample(state: State, total: int, n: int) -> torch.Tensor:
    """``n`` positions among the window's ``total`` queries, drawn from
    the seed, in ascending order."""
    g = torch.Generator().manual_seed(datagen.stream_seed(state.seed,
                                                          "check"))
    return torch.randperm(total, generator=g)[:n].sort().values


def _dtw_at(state: State, q: torch.Tensor, ids: torch.Tensor,
            pairs: int = 65536) -> torch.Tensor:
    """The reference's ``DTW(q_r, x[ids_r])`` row by row, ``+inf`` where
    the id is outside the store; in sweeps of at most ``pairs`` rows."""
    series = state.store["series"]
    N = series.shape[0]
    ok = (ids >= 0) & (ids < N)
    safe = ids.clamp(0, N - 1)
    w = int(state.mix["w"])
    d = torch.cat([ref.dtw_sweep(q[s:s + pairs], series[safe[s:s + pairs]],
                                 w) for s in range(0, q.shape[0], pairs)])
    return torch.where(ok, d, float("inf"))


def gap(state: State, q: torch.Tensor, d_ans: torch.Tensor,
        i_ans: torch.Tensor, check_every: int) -> float:
    """The largest of ``|d - d*|`` and ``DTW(q, x[id]) - d*``, over
    ``d*``, across the queries ``q``: ``d`` and ``id`` their answers,
    ``d*`` the reference's exact nearest distance.  The answer's own
    neighbour bounds the reference's search from above: only a candidate
    that could beat it is swept."""
    series = state.store["series"]
    w = int(state.mix["w"])
    d_ans = d_ans.float()
    d_at = _dtw_at(state, q, i_ans.long())
    d_best, _ = ref.nn_dtw(q, series, w, threshold=d_at,
                           check_every=check_every)
    d_star = torch.minimum(d_best, d_at)
    g = torch.maximum((d_ans - d_star).abs(), d_at - d_star) \
        / d_star.clamp(min=1e-30)
    g = torch.where(torch.isfinite(g), g, float("inf"))
    return float(g.max())


def judge(state: State, outputs: list, n_check: int,
          check_every: int) -> dict:
    """The numbers that decide ``correct``:

    missing:  window queries with no valid answer (a non-finite distance
              or an id outside the store);
    dist_gap: the larger of two readings: over every window answer with
              an id in the store, ``|d - DTW(q, x[id])| / DTW(q, x[id])``
              (the distance it returned against the reference's DTW of
              the pair it named); and ``gap`` over a sample of the
              window's queries drawn from the seed (whether the named
              series is truly nearest).
    """
    N = state.store["series"].shape[0]
    d = torch.cat([o[0] for o in outputs]).float()
    i = torch.cat([o[1] for o in outputs]).long()
    ok = (i >= 0) & (i < N)
    missing = int((~torch.isfinite(d) | ~ok).sum())
    q = window_queries(state, len(outputs))
    d_at = _dtw_at(state, q, i)
    every = (d - d_at).abs() / d_at.clamp(min=1e-30)
    every = torch.where(torch.isfinite(every), every, float("inf"))
    every = torch.where(ok, every, 0.0)
    pos = sample(state, q.shape[0], n_check)
    sampled = gap(state, q[pos], d[pos], i[pos], check_every)
    return {"missing": float(missing),
            "dist_gap": max(float(every.max()), sampled)}


def control(state: State, q: torch.Tensor, check_every: int,
            dtype=torch.bfloat16) -> float:
    """The reference in the program's place, computed in ``dtype``, on
    the queries ``q``: its ``gap``."""
    d, i = ref.nn_dtw(q.to(dtype), state.store["series"].to(dtype),
                      int(state.mix["w"]), check_every=check_every)
    return gap(state, q, d, i, check_every)
