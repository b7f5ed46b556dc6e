"""The device generator's z-normalisation, class structure and seeds."""

from __future__ import annotations

import torch

from portbench import datagen

CFG = dict(n_store=400, length=64, n_classes=8, data_seed=7, warp=0.5,
           noise=0.15, amp_jitter=0.1)


def test_znormalised_and_labelled():
    protos, x, y = datagen.make_store(CFG, 5, "cpu")
    assert x.shape == (400, 64) and x.dtype == torch.float32
    assert y.dtype == torch.int32 and set(y.tolist()) == set(range(8))
    assert x.mean(1).abs().max() < 1e-5
    assert (x.std(1, unbiased=False) - 1).abs().max() < 1e-4
    assert (protos.std(1, unbiased=False) - 1).abs().max() < 1e-4


def test_instances_follow_their_class():
    """An instance lies nearer its own prototype than any other, for
    nearly every instance: the classes are what the search separates."""
    protos, x, y = datagen.make_store(CFG, 6, "cpu")
    d = torch.cdist(x, protos)
    assert (d.argmin(1) == y.long()).float().mean() > 0.9


def test_seeds():
    a = datagen.make_store(CFG, 1, "cpu")
    b = datagen.make_store(CFG, 1, "cpu")
    c = datagen.make_store(CFG, 2, "cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(a[0], c[0])         # the configuration's prototypes
    assert not torch.equal(a[1], c[1])     # the run's instances
    seeds = {datagen.stream_seed(2 ** 31 + 9, "batch", b)
             for b in range(100)}
    assert len(seeds) == 100 and max(seeds) < 2 ** 63
