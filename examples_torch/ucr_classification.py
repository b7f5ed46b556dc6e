"""End-to-end driver: NN-DTW time-series classification with the
LB_ENHANCED cascade (the paper's headline application, SS IV-B), on the
PyTorch/CUDA port (port of ``examples/ucr_classification.py``).

Builds a UCR-like dataset, indexes the training set with store-level plan
calibration (the planner prices every tier on a sample of the store and
commits the optimised verification plan, search/planner.py), classifies
the test set with the committed plan and exact verification, and reports
accuracy, the per-tier pruning-power table, and the warm search's time
against the unpruned brute force (both synchronised, after one warm-up
call each).

Run: PYTHONPATH=src python examples_torch/ucr_classification.py
     [--window 0.2] [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data import make_dataset
from repro_torch.search import (
    CascadeConfig,
    EngineConfig,
    brute_force,
    build_index,
    default_plan,
    nn_search,
)
from repro_torch.search import planner as plr


def _timed(fn, dev: torch.device):
    """One warm-up call, then one timed call, synchronised on the card."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--window", type=float, default=0.2)
    ap.add_argument("--v", type=int, default=4)
    ap.add_argument("--length", type=int, default=64)
    ap.add_argument("--per-class", type=int, default=200,
                    help="the paper's regime is large N: pruning pays "
                         "off as the store grows")
    ap.add_argument("--n-test", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    ds = make_dataset(
        n_classes=5, n_train_per_class=args.per_class,
        n_test_per_class=args.n_test, length=args.length, seed=7,
    )
    w = max(1, int(args.window * ds.length))
    print(f"dataset: {ds.x_train.shape[0]} train / {ds.x_test.shape[0]} test, "
          f"L={ds.length}, W={w}, V={args.v}, device {dev}")

    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=args.v),
                       verify_chunk=64, k=1, auto_plan=True)
    # store-level calibration: the planner prices the default plan on a
    # sample of the store itself and commits the optimised plan, so the
    # first real query batch below starts warm
    idx = build_index(ds.x_train, w, ds.y_train, calibrate=cfg, device=dev)
    decision = plr.lookup_plan(idx, cfg.cascade, cfg.k,
                               default_plan(cfg.cascade))
    print(f"committed plan    : {decision.summary()}")

    # search the test set under the committed plan, with the pruning report
    res, stats = nn_search(idx, ds.x_test, cfg, with_stats=True)
    pred = idx.labels[res.idx.long()][:, 0].cpu().numpy()

    # steady-state times: the committed plan pinned, as a warm search runs
    q = torch.as_tensor(ds.x_test, device=dev)
    _, t_cascade = _timed(
        lambda: nn_search(idx, q, cfg, plan=decision.plan), dev)
    (bd, bi), t_brute = _timed(lambda: brute_force(idx, q, w, k=1), dev)

    acc = float(np.mean(pred == ds.y_test))
    prune = float(res.pruning_power().mean())
    exact = bool(torch.equal(res.idx, bi) and torch.equal(res.dists, bd))

    print()
    print(stats.table())       # the paper's pruning-power readout, per tier
    print()
    print(f"accuracy          : {acc:.1%}")
    print(f"pruning power     : {prune:.1%} of DTW computations skipped")
    print(f"mean DTW verified : {float(res.n_dtw.float().mean()):.1f} "
          f"of {idx.n} candidates")
    print(f"cascade time      : {t_cascade:.4f}s   brute force: "
          f"{t_brute:.4f}s ({t_brute / t_cascade:.1f}x speedup)")
    # the default-on exactness guards (search/guards.py)
    if stats.guards is not None:
        trip = stats.guards.tripped()
        verdict = "tripped: " + ", ".join(trip) if trip else "all clear"
        print(f"exactness guards  : {verdict}"
              + ("   [DEGRADED]" if stats.degraded else ""))
        print(f"                    {stats.guards.summary()}")
    print(f"exact vs brute force: {exact}")
    if not exact:
        raise SystemExit("the cascade changed the NN result!")


if __name__ == "__main__":
    main()
