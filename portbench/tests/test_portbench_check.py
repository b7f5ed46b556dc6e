"""The check that decides ``correct`` fails what it must: the control
(the reference in the program's place, in bfloat16) and the program's
answers altered where they are produced.  Each test drives the rest of a
run (set-up, warm-up, window, judge) past the look for a card."""

from __future__ import annotations

import contextlib

import pytest
import torch

from portbench.tests.conftest import CELLS

SEED = 2 ** 32 + 3


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limit(tiny_cell, name):
    from portbench import spec

    cell = tiny_cell(name, batch=8)
    drv = spec.system(cell)
    st = drv.prepare(cell.config, cell.traffic, SEED, "cpu")
    outs = [drv.run_batch(st, "window", b)[1] for b in range(2)]
    chk = cell.run["check"]
    q = drv.window_queries(st, len(outs))
    q = q[drv.sample(st, q.shape[0], 16)]
    prog = drv.judge(st, outs, 16, chk["check_every"])["dist_gap"]
    ctrl = drv.control(st, q, chk["check_every"])
    assert prog <= chk["limits"]["dist_gap"] < ctrl


@pytest.mark.parametrize("name", CELLS)
def test_every_answers_distance_is_judged(tiny_cell, name):
    """One answer's distance off by 1e-3, at a position the sample of
    one query leaves out: the check of every answer's distance catches
    it."""
    from portbench import spec

    cell = tiny_cell(name, batch=8)
    drv = spec.system(cell)
    st = drv.prepare(cell.config, cell.traffic, SEED, "cpu")
    outs = [drv.run_batch(st, "window", b)[1] for b in range(3)]
    chk = cell.run["check"]
    every, limit = chk["check_every"], chk["limits"]["dist_gap"]
    assert drv.judge(st, outs, 1, every)["dist_gap"] == 0.0
    b, r = divmod((int(drv.sample(st, 24, 1)[0]) + 5) % 24, 8)
    d = outs[b][0].clone()
    d[r] *= 1 + 1e-3
    outs[b] = (d,) + tuple(outs[b][1:])
    assert drv.judge(st, outs, 1, every)["dist_gap"] > limit


@contextlib.contextmanager
def _altered_search(kind: str):
    """``nn_search``'s answers altered as the engine hands them back:
    every query's id moved to the next store series, one query's
    distance lost, or the last query's distance of each batch off by
    1e-3."""
    from repro_torch.search import engine

    real = engine.nn_search

    def altered(index, queries, cfg, **kw):
        res = real(index, queries, cfg, **kw)
        d, i = res.dists.clone(), res.idx.clone()
        if kind == "id":
            i = (i + 1) % index.n
        elif kind == "missing":
            d[0, 0] = float("nan")
        elif kind == "last_dist":
            d[-1, 0] = d[-1, 0] * (1 + 1e-3)
        return type(res)(dists=d, idx=i, n_dtw=res.n_dtw, lb=res.lb)

    from repro_torch import search

    search.nn_search = altered
    try:
        yield
    finally:
        search.nn_search = real


@contextlib.contextmanager
def _altered_dtw():
    """Every DTW value scaled by 1 + 1e-3 where the kernel route makes
    it (the ``dtw_out`` seam of ``kernels/ops.py``)."""
    from repro_torch.testing.faults import inject

    with inject("dtw_out", lambda d: d * (1 + 1e-3)):
        yield


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["id", "missing", "last_dist",
                                   "dtw_value"])
def test_altered_answers_are_not_correct(tiny_cell, name, fault):
    from portbench import harness

    cell = tiny_cell(name)
    ctx = _altered_dtw() if fault == "dtw_value" else _altered_search(fault)
    with ctx:
        res = harness.run(cell, SEED, 0.1, False, device="cpu")
    assert res["correct"] is False
    if fault == "missing":
        assert res["failed"] >= 1
    else:
        assert res["check"]["dist_gap"]["value"] > \
            res["check"]["dist_gap"]["limit"]


def test_sound_run_is_correct_at_the_same_size(tiny_cell):
    from portbench import harness

    res = harness.run(tiny_cell("search_1m.w03"), SEED, 0.1, False,
                      device="cpu")
    assert res["correct"] is True and res["failed"] == 0
