"""The plain reference against the program's plain route on small
stores, and its parts against each other."""

from __future__ import annotations

import pytest
import torch

from portbench.reference import nn_dtw as ref


@pytest.mark.parametrize("L", [17, 48])
@pytest.mark.parametrize("wfrac", [0.0, 0.1, 0.3, 1.0])
def test_sweep_bit_equal_to_program_plain_dtw(L, wfrac):
    from repro_torch.kernels.ref import dtw_band_ref

    g = torch.Generator().manual_seed(L)
    a = torch.randn(40, L, generator=g).cumsum(1)
    b = torch.randn(40, L, generator=g).cumsum(1)
    w = L if wfrac == 1.0 else int(wfrac * L)
    got = ref.dtw_sweep(a, b, w)
    assert torch.equal(got, dtw_band_ref(a, b, w))
    # a cutoff drops only pairs above it, and leaves the rest exact
    cut = got.median()
    cg = ref.dtw_sweep(a, b, w, cutoff=cut, check_every=3)
    assert torch.equal(cg, torch.where(got <= cut, got, float("inf")))


@pytest.mark.parametrize("w", [3, 12, 48])
def test_lb_keogh_never_exceeds_dtw(w):
    g = torch.Generator().manual_seed(w)
    q = torch.randn(5, 48, generator=g)
    s = torch.randn(30, 48, generator=g)
    lb = ref.lb_keogh(q, s, w)
    d = ref.dtw_sweep(q.repeat_interleave(30, 0), s.repeat(5, 1), w)
    assert (lb <= d.reshape(5, 30)).all()
    assert (lb > 0).any()


@pytest.mark.parametrize("w", [5, 24, 48])
def test_nn_dtw_matches_program_brute_force(w):
    from portbench import datagen
    from repro_torch.search import brute_force, build_index

    cfg = dict(n_store=300, length=48, n_classes=4, data_seed=3, warp=0.5,
               noise=0.15, amp_jitter=0.1)
    protos, store, labels = datagen.make_store(cfg, 11, "cpu")
    g = datagen.generator(12, "q", device="cpu")
    q = datagen.instances(protos, torch.arange(9) % 4, g, warp=0.5,
                          noise=0.15, amp=0.1)
    idx = build_index(store, w, labels, device="cpu")
    bd, bi = brute_force(idx, q, w, use_kernels=False)
    d, i = ref.nn_dtw(q, store, w, pairs_per_sweep=64, check_every=7)
    assert torch.equal(d, bd[:, 0])
    assert torch.equal(ref.dtw_sweep(q, store[i], w), d)
    # with the judged neighbour's distance as the threshold
    dt, _ = ref.nn_dtw(q, store, w, threshold=bd[:, 0] * 1.5)
    assert torch.equal(dt, d)
