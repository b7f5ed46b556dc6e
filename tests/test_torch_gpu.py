"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the search path on the card against the same search on the
CPU.  Marked ``gpu``; without a card every test skips (the decision is
made in a fixture, never at import).  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: envelopes, banded DTW and the bands-only LB_ENHANCED are
bit-equal with the same +-inf positions; the full LB_ENHANCED forms agree
to rtol 1e-5, atol 1e-6 (their L-term sums run in another order).
"""

import numpy as np
import pytest
import torch

from repro_torch.data import make_dataset
from repro_torch.kernels import _build, ref
from repro_torch.kernels.dtw_band import dtw_band_cuda
from repro_torch.kernels.envelope import envelope_cuda
from repro_torch.kernels.lb_enhanced import lb_enhanced_cuda
from repro_torch.kernels.lb_enhanced_pairwise import lb_enhanced_pairwise_cuda
from repro_torch.search import (
    CascadeConfig,
    EngineConfig,
    brute_force,
    build_index,
    nn_search,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest -m gpu "
                    "tests/test_torch_gpu.py` on a machine with one")
    return torch.device("cuda")


def _rand(dev, seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dev)


def _check(got, want, exact):
    assert got.shape == want.shape
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    fin = torch.isfinite(want)
    if exact:
        assert torch.equal(got[fin], want[fin])
    else:
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,L,w", [(5, 33, 0), (7, 33, 1), (3, 67, 16),
                                   (4, 64, 64), (2, 16384, 51),
                                   (3, 1001, 999), (1, 1, 0)])
def test_envelope_kernel_bit_equal(dev, n, L, w):
    x = _rand(dev, 0, n, L)
    u, lo = envelope_cuda(x, w)
    ru, rlo = ref.envelope_ref(x, w)
    _check(u, ru, exact=True)
    _check(lo, rlo, exact=True)


@pytest.mark.parametrize("Q,C,L,w,v", [(3, 37, 33, 8, 4), (9, 70, 64, 1, 4),
                                       (5, 33, 31, 0, 4), (4, 40, 24, 24, 8),
                                       (2, 65, 9, 9, 4)])
@pytest.mark.parametrize("with_live", [False, True])
def test_lb_enhanced_kernel(dev, Q, C, L, w, v, with_live):
    q, c = _rand(dev, 1, Q, L), _rand(dev, 2, C, L)
    u, lo = ref.envelope_ref(c, w)
    live = None
    if with_live:
        live = _rand(dev, 3, C) > -0.5
        live[:32] = False                        # an all-dead candidate tile
    for bands_only in (True, False):
        got = lb_enhanced_cuda(q, c, u, lo, w, v, live=live,
                               bands_only=bands_only)
        want = ref.lb_enhanced_ref(q, c, u, lo, w, v, live=live,
                                   bands_only=bands_only)
        _check(got, want, exact=bands_only)


@pytest.mark.parametrize("P,L,w", [(9, 33, 7), (130, 47, 11), (70, 64, 64),
                                   (16, 5, 4), (33, 8, 1), (40, 31, 0)])
@pytest.mark.parametrize("with_live", [False, True])
def test_lb_enhanced_pairwise_kernel(dev, P, L, w, with_live):
    q, c = _rand(dev, 4, P, L), _rand(dev, 5, P, L)
    u, lo = ref.envelope_ref(c, w)
    live = None
    if with_live:
        live = _rand(dev, 6, P) > -0.5
        live[:8] = False                         # an all-dead block
    for bands_only in (True, False):
        got = lb_enhanced_pairwise_cuda(q, c, u, lo, w, 4, live=live,
                                        bands_only=bands_only)
        want = ref.lb_enhanced_pairwise_ref(q, c, u, lo, w, 4, live=live,
                                            bands_only=bands_only)
        _check(got, want, exact=bands_only)


@pytest.mark.parametrize("P,L,w", [(37, 33, 0), (37, 33, 1), (37, 33, 8),
                                   (37, 33, 33), (20, 100, 25), (5, 513, 51),
                                   (3, 1, 0), (6, 2, 5), (4, 700, 700)])
def test_dtw_band_kernel_bit_equal_with_cutoffs(dev, P, L, w):
    a, b = _rand(dev, 7, P, L), _rand(dev, 8, P, L)
    exact = ref.dtw_band_ref(a, b, w)
    _check(dtw_band_cuda(a, b, w), exact, exact=True)
    g = torch.Generator().manual_seed(9)
    cut = exact * (0.5 + torch.rand(P, generator=g).to(dev))
    cut[::5] = float("-inf")
    got = dtw_band_cuda(a, b, w, cut)
    _check(got, ref.dtw_band_ref(a, b, w, cut), exact=True)
    assert torch.isposinf(got[::5]).all()
    _check(dtw_band_cuda(a, b, w, cut, row_block=7),
           ref.dtw_band_ref(a, b, w, cut, row_block=7), exact=True)


def test_wrappers_count_launches_and_refuse_bad_input(dev):
    _build.reset_counts()
    x = _rand(dev, 10, 4, 32)
    envelope_cuda(x, 3)
    dtw_band_cuda(x, x, 3)
    dtw_band_cuda(x, x, 3, torch.zeros(4, device=dev))
    assert _build.counts() == {"envelope": 1, "lb_enhanced": 0,
                               "lb_enhanced_pairwise": 0, "dtw_band": 2}
    with pytest.raises(ValueError, match="float32"):
        dtw_band_cuda(x.double(), x.double(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        envelope_cuda(x.t(), 3)
    with pytest.raises(ValueError, match="shape"):
        dtw_band_cuda(x, x[:3], 3)
    long = _rand(dev, 11, 1, 40000)
    with pytest.raises(ValueError, match="shared memory"):
        dtw_band_cuda(long, long, 40000)
    assert _build.counts()["dtw_band"] == 2


@pytest.mark.parametrize("k,schedule", [(1, "bound"), (3, "index")])
def test_search_on_the_card_equals_the_cpu_search(dev, k, schedule):
    from repro_torch.search.pipeline import default_plan

    ds = make_dataset(n_classes=4, n_train_per_class=64,
                      n_test_per_class=8, length=96, seed=5)
    w = 9
    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=4, candidate_chunk=64),
                       verify_chunk=8, k=k)
    plan = default_plan(cfg.cascade, schedule=schedule)
    gpu_idx = build_index(ds.x_train, w, ds.y_train)       # device=None
    assert gpu_idx.device.type == "cuda"
    cpu_idx = build_index(ds.x_train, w, ds.y_train, device="cpu")
    _build.reset_counts()
    res = nn_search(gpu_idx, ds.x_test, cfg, plan=plan)
    assert all(n > 0 for name, n in _build.counts().items()
               if name != "envelope")
    want = nn_search(cpu_idx, ds.x_test, cfg, plan=plan)
    assert torch.equal(res.idx.cpu(), want.idx)
    assert torch.equal(res.n_dtw.cpu(), want.n_dtw)
    assert torch.equal(res.dists.cpu(), want.dists)
    bd, bi = brute_force(gpu_idx, ds.x_test, w, k=k)
    assert torch.equal(bi, res.idx) and torch.equal(bd, res.dists)
    np.testing.assert_array_equal(gpu_idx.upper.cpu().numpy(),
                                  cpu_idx.upper.numpy())
