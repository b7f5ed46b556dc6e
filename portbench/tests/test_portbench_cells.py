"""Every cell's path at tiny sizes on the CPU, through the plain
versions: the window, the metrics and the check."""

from __future__ import annotations

import json

import pytest

from portbench.tests.conftest import CELLS

SEED = 2 ** 31 + 17


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(tiny_cell, name, trace):
    from portbench import harness

    cell = tiny_cell(name)
    res = harness.run(cell, SEED, 0.2, trace, device="cpu")
    json.dumps(res)                               # one JSON line
    assert res["correct"] is True
    assert res["failed"] == 0
    assert res["attempted"] >= cell.traffic["batch"]
    assert list(res)[-1] == "check"
    assert res["check"]["dist_gap"]["value"] == 0.0
    assert res["check"]["missing"]["value"] == 0.0
    names = set(res["metrics"])
    if trace:
        # counters on the CPU; spans and the trace are the card's only
        assert names == {"dtw_calls_per_batch", "dtw_per_query",
                         "index_build_s"}
        assert res["metrics"]["dtw_calls_per_batch"]["value"] >= 2
    else:
        assert names == {"queries_per_s", "setup_s"}
        assert res["metrics"]["queries_per_s"]["unit"] == "queries/s"


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_answers(tiny_cell, name):
    from portbench import spec

    cell = tiny_cell(name)
    drv = spec.system(cell)
    got = []
    for _ in range(2):
        st = drv.prepare(cell.config, cell.traffic, 7, "cpu")
        got.append([drv.run_batch(st, "window", b)[1] for b in range(2)])
    for (d0, i0, n0), (d1, i1, n1) in zip(*got):
        assert d0.equal(d1) and i0.equal(i1) and n0.equal(n1)


def test_window_covers_whole_batches(tiny_cell):
    """The window ends with the last batch started before its time, and
    its rate is over all of it."""
    from portbench import harness

    res = harness.run(tiny_cell("handoutlines.wfull"), 3, 0.0, False,
                      device="cpu")
    assert res["counters"]["batches"] == 1
    qps = res["metrics"]["queries_per_s"]["value"]
    assert qps == pytest.approx(res["attempted"]
                                / res["counters"]["window_s"])
