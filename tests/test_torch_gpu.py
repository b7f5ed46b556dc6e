"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the search path on the card against the same search on the
CPU.  Marked ``gpu``; without a card every test skips (the decision is
made in a fixture, never at import).  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: envelopes, banded DTW (K4 and the per-step K6, each in its
warp, slots and block forms, and the three forms of the wide-band K5), the bands-only LB_ENHANCED and the sketch
bound are bit-equal with the same +-inf positions; the full
LB_ENHANCED forms and LB_Keogh agree to rtol 1e-5, atol 1e-6 (their
L-term sums run in another order).  Flash attention (K9) agrees with its
plain version to rtol 1e-4, atol 1e-5 in float32 (its CUDA-core form)
and to rtol 1e-2, atol 1e-2 in bfloat16 (its tensor-core form: P is
rounded to bf16 for the PV product, and the outputs are bf16); its
f32-arithmetic form past D = 256 to the same tolerances by input type,
bf16 also to a relative RMS error of 1e-2; the
selective scan (K10) bit for bit (its N-sum keeps the plain version's
order; where the tests below say rtol 1e-5, atol 1e-6, they hold the
sweep of earlier slices to that bound too), its wide-state form past
N = 256 bit for bit too.
"""

import numpy as np
import pytest
import torch

from repro_torch.data import make_dataset
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.dtw_band import (
    K4_FORMS,
    K4_WARP_MAX_WB,
    K5_FORMS,
    K5_ROWS_MAX_L,
    STREAM_BLOCKS_PER_SM,
    dtw_band_cuda,
    dtw_band_route,
    k4_form,
    k5_form,
)
from repro_torch.kernels.envelope import envelope_cuda
from repro_torch.kernels.flash_attention import (
    MAX_HEAD_DIM,
    flash_attention_cuda,
)
from repro_torch.kernels.lb_enhanced import lb_enhanced_cuda
from repro_torch.kernels.lb_enhanced_pairwise import lb_enhanced_pairwise_cuda
from repro_torch.kernels.lb_keogh import lb_keogh_cuda
from repro_torch.kernels.mamba_scan import MAX_STATE, mamba_scan_cuda
from repro_torch.kernels.sketch import sketch_bound_cuda
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


DTW_SWEEP = [(37, 33, 0), (37, 33, 1), (37, 33, 8), (37, 33, 33),
             (20, 100, 25), (5, 513, 51), (3, 1, 0), (6, 2, 5),
             (4, 700, 700)]


def _holding_forms(L, w):
    """K4's forms that hold the band of ``(L, w)``: all three up to
    wb = 255, the slots and block forms past it."""
    wb = min(w, max(L - 1, 0))
    return K4_FORMS if wb <= K4_WARP_MAX_WB else K4_FORMS[1:]


@pytest.mark.parametrize("P,L,w", DTW_SWEEP)
def test_dtw_band_kernel_bit_equal_with_cutoffs(dev, P, L, w):
    """K4 in the form ``k4_form`` picks and in each form forced that
    holds the band (the block form alone past wb = 255), without cutoffs,
    with cutoffs (every fifth slot -inf) and with row blocks of 7, each
    form under its own launch count."""
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
    for form in _holding_forms(L, w):
        _build.reset_counts()
        _check(dtw_band_cuda(a, b, w, form=form), exact, exact=True)
        _check(dtw_band_cuda(a, b, w, cut, row_block=7, form=form),
               ref.dtw_band_ref(a, b, w, cut, row_block=7), exact=True)
        name = "dtw_band" if form == "warp" else f"dtw_band_{form}"
        assert _build.counts()[name] == 2
        assert sum(_build.counts().values()) == 2


@pytest.mark.parametrize("wb", [31, 32, 63, 64, 127, 128, K4_WARP_MAX_WB,
                                K4_WARP_MAX_WB + 1])
def test_dtw_band_forms_at_the_warp_form_edges(dev, wb):
    """Bands at each warp-form slot count's edge (2, 4, 8, 16 slots a
    lane) and just past the warp form (wb = 256 is the slots form's):
    every form that holds the band and K6 bit-equal to the plain version,
    with row-block cutoffs."""
    P, L = 6, 2 * wb + 3
    a, b = _rand(dev, 60, P, L), _rand(dev, 61, P, L)
    exact = ref.dtw_band_ref(a, b, wb)
    cut = exact * torch.tensor([0.3, 0.8, 0.95, 1.01, 2.0, float("-inf")],
                               device=dev)
    want = ref.dtw_band_ref(a, b, wb, cut)
    want7 = ref.dtw_band_ref(a, b, wb, cut, row_block=7)
    forms = _holding_forms(L, wb)
    assert k4_form(L, wb) == forms[0]
    if wb > K4_WARP_MAX_WB:
        with pytest.raises(ValueError, match="warp form"):
            dtw_band_cuda(a, b, wb, form="warp")
    for form in forms:
        _check(dtw_band_cuda(a, b, wb, form=form), exact, exact=True)
        _check(dtw_band_cuda(a, b, wb, cut, form=form), want, exact=True)
        _check(dtw_band_cuda(a, b, wb, cut, row_block=7, form=form), want7,
               exact=True)
        _check(dtw_band_cuda(a, b, wb, cut, early_exit=False, form=form),
               ref.dtw_band_ref(a, b, wb, cut, row_block=1), exact=True)
    assert torch.isfinite(want[3:5]).all() and torch.isposinf(want[5])


@pytest.mark.parametrize("wb", [256, 257, 300, 511, 1023, 4095, 7193,
                                14463])
@pytest.mark.parametrize("at_w_eq_L", [True, False])
def test_slots_form_sweep(dev, wb, at_w_eq_L):
    """K4's slots form and its K6 variant at bands across its range (one
    warp a pair to wb = 511, 2-16 warps a block, a cluster of two blocks
    past wb = 8191), at w = L (L = wb + 1) and inside a longer series,
    without cutoffs, with cutoffs that let some pairs finish and kill
    others (one -inf), with every pair dead (cutoff 0) and with row blocks
    of 7: bit-equal to the plain version, one ``dtw_band_slots`` launch a
    call of the op."""
    P = 4
    L = wb + 1 if at_w_eq_L else wb + 700
    w = L if at_w_eq_L else wb
    assert k4_form(L, w) == "slots"
    a, b = _rand(dev, 70 + wb, P, L), _rand(dev, 71 + wb, P, L)
    exact = ref.dtw_band_ref(a, b, w)
    _build.reset_counts()
    _check(ops.dtw_band_op(a, b, w), exact, exact=True)
    assert _build.counts()["dtw_band_slots"] == 1
    cut = exact * torch.tensor([0.5, 0.97, 1.01, float("-inf")], device=dev)
    for rb in (None, 7, 1):
        want = ref.dtw_band_ref(a, b, w, cut, row_block=rb)
        _check(dtw_band_cuda(a, b, w, cut, row_block=rb), want, exact=True)
    _check(dtw_band_cuda(a, b, w, cut, early_exit=False), want, exact=True)
    got = dtw_band_cuda(a, b, w, cut)
    assert torch.isfinite(got[2]) and torch.isposinf(got[3])
    # every pair dead at the first check (cutoff 0), in K4 and K6
    dead = torch.zeros(P, device=dev)
    want = ref.dtw_band_ref(a, b, w, dead)
    assert torch.isposinf(want).all()
    for rb in (None, 7):
        _check(dtw_band_cuda(a, b, w, dead, row_block=rb), want, exact=True)
    _check(dtw_band_cuda(a, b, w, dead, early_exit=False), want, exact=True)


def test_nn_search_at_large_windows_runs_the_slots_form(dev):
    """w = L and w = 0.6 L on a small store of L = 600: every DTW of the
    search runs in K4's slots form (never the warp or block form, nor
    K5), ids and distances equal the card's brute force."""
    ds = make_dataset(n_classes=2, n_train_per_class=32, n_test_per_class=2,
                      length=600, seed=6)
    L = ds.length
    for w in (L, int(0.6 * L)):
        cfg = EngineConfig(cascade=CascadeConfig(w=w, v=4), verify_chunk=8,
                           k=1)
        idx = build_index(ds.x_train, w, ds.y_train, device=dev)
        _build.reset_counts()
        res = nn_search(idx, ds.x_test, cfg)
        counts = _build.counts()
        assert counts["dtw_band_slots"] > 0
        assert counts["dtw_band"] == counts["dtw_band_block"] == 0
        assert counts["dtw_band_stream"] == 0
        bd, bi = brute_force(idx, ds.x_test, w, k=1)
        assert torch.equal(bi, res.idx) and torch.equal(bd, res.dists)


@pytest.mark.parametrize("P,L,w", DTW_SWEEP)
def test_stream_and_step_kernels_bit_equal_at_the_sweep(dev, P, L, w):
    """K5 forced (``stream=True``) in each of its three forms and K6
    (``early_exit=False``) at K4's sweep shapes, with and without cutoffs
    (every fifth slot -inf): equal to the plain versions and to K4."""
    a, b = _rand(dev, 7, P, L), _rand(dev, 8, P, L)
    exact = ref.dtw_band_ref(a, b, w)
    g = torch.Generator().manual_seed(9)
    cut = exact * (0.5 + torch.rand(P, generator=g).to(dev))
    cut[::5] = float("-inf")
    for c in (None, cut):
        k4 = dtw_band_cuda(a, b, w, c)
        want = ref.dtw_band_ref(a, b, w, c)
        _check(k4, want, exact=True)
        for form in K5_FORMS:
            _check(dtw_band_cuda(a, b, w, c, stream=True, form=form), want,
                   exact=True)
            _check(dtw_band_cuda(a, b, w, c, stream=True, row_block=7,
                                 form=form),
                   ref.dtw_band_ref(a, b, w, c, row_block=7), exact=True)
        step = dtw_band_cuda(a, b, w, c, early_exit=False)
        _check(step, ref.dtw_band_ref(a, b, w, c, row_block=1), exact=True)
        _check(step, k4, exact=True)
        for form in _holding_forms(L, w):
            _check(dtw_band_cuda(a, b, w, c, early_exit=False, form=form),
                   k4, exact=True)


@pytest.mark.parametrize("with_cutoff", [False, True])
def test_stream_kernel_loops_over_pairs_past_its_grid(dev, with_cutoff):
    """P = 600 pairs, more than the persistent grid of K5's scratch form
    (2 blocks per SM), so its blocks run several pairs in turn (the
    scratch re-initialised per pair, -inf slots skipped): bit-equal to the
    plain version, to K4 and to K5's other forms (a block or a cluster a
    pair)."""
    P, L, w = 600, 97, 24
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert P > STREAM_BLOCKS_PER_SM * sms
    a, b = _rand(dev, 18, P, L), _rand(dev, 19, P, L)
    cut = None
    if with_cutoff:
        g = torch.Generator().manual_seed(20)
        cut = ref.dtw_band_ref(a, b, w) * (
            0.5 + torch.rand(P, generator=g).to(dev))
        cut[::7] = float("-inf")
    want = ref.dtw_band_ref(a, b, w, cut)
    got = dtw_band_cuda(a, b, w, cut, stream=True, form="scratch")
    _check(got, want, exact=True)
    _check(got, dtw_band_cuda(a, b, w, cut), exact=True)
    for form in ("rows", "cluster"):
        _check(dtw_band_cuda(a, b, w, cut, stream=True, form=form), want,
               exact=True)
    if with_cutoff:
        assert torch.isposinf(got[::7]).all()
        # cutoffs below a pair's DTW kill it too, some abandon mid-sweep
        assert torch.isfinite(got).any()
        assert torch.isposinf(got).sum() > cut[::7].numel()


def test_stream_kernel_just_over_the_crossover(dev):
    """wb = 14464 (w = L = 14465), the first band K4 cannot hold: the op
    routes to K5 (its rows form), bit-equal to the plain version, a lone
    cutoff kills one pair."""
    L = 14465
    assert dtw_band_route(L, L) == "stream"
    assert dtw_band_route(L - 1, L - 1) == "resident"
    a, b = _rand(dev, 15, 2, L), _rand(dev, 16, 2, L)
    _build.reset_counts()
    got = ops.dtw_band_op(a, b, L)
    assert _build.counts()["dtw_band_stream"] == 1
    assert _build.counts()["dtw_band"] == 0
    assert _build.counts()["dtw_band_slots"] == 0
    assert _build.counts()["dtw_band_block"] == 0
    want = ref.dtw_band_ref(a, b, L)
    _check(got, want, exact=True)
    cut = torch.stack([want[0] * 2, want[1] * 0.5])
    got_c = ops.dtw_band_op(a, b, L, cut, early_exit=False)
    _check(got_c, ref.dtw_band_ref(a, b, L, cut), exact=True)
    assert torch.isfinite(got_c[0]) and torch.isposinf(got_c[1])


@pytest.mark.parametrize("L,form", [
    (14465, "rows"),                        # just over K4
    (K5_ROWS_MAX_L, "rows"),                # the (a)/(b) edge
    (K5_ROWS_MAX_L + 1, "cluster"),
    (65536, "cluster"),                     # 3 blocks a pair
])
def test_stream_forms_at_their_boundary_shapes(dev, L, form):
    """Each K5 form where ``k5_form`` puts its edges (w = L, two pairs),
    without cutoffs and with one that lets a pair finish and one that
    kills it: bit-equal to the plain version, launched under its own
    count.  The scratch form starts past wb = 231423, too long for the
    plain version here; it runs forced at the first shape."""
    assert k5_form(L, L) == form
    a, b = _rand(dev, 50, 2, L), _rand(dev, 51, 2, L)
    want = ref.dtw_band_ref(a, b, L)
    cut = torch.stack([want[0] * 2, want[1] * 0.5])
    want_c = ref.dtw_band_ref(a, b, L, cut)
    forms = [form, "scratch"] if L == 14465 else [form]
    for f in forms:
        _build.reset_counts()
        _check(dtw_band_cuda(a, b, L, stream=True, form=f), want, exact=True)
        _check(dtw_band_cuda(a, b, L, cut, stream=True, form=f), want_c,
               exact=True)
        name = {"rows": "dtw_band_stream"}.get(f, f"dtw_band_stream_{f}")
        assert _build.counts()[name] == 2
        assert sum(_build.counts().values()) == 2
    assert torch.isfinite(want_c[0])


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7, 8])
def test_stream_cluster_form_at_every_cluster_size(dev, n):
    """K5's cluster form forced to n blocks a pair (a cluster of n, the
    band's slots in n slices, some of them empty at w = 3), with and
    without cutoffs: bit-equal to the plain version.  Fewer blocks than
    the band needs, or more than a portable cluster, are refused."""
    P, L = 5, 301
    a, b = _rand(dev, 60, P, L), _rand(dev, 61, P, L)
    g = torch.Generator().manual_seed(62)
    for w in (3, 40, L):
        exact = ref.dtw_band_ref(a, b, w)
        cut = exact * (0.5 + torch.rand(P, generator=g).to(dev))
        cut[::4] = float("-inf")
        for c, R in ((None, None), (cut, None), (cut, 7)):
            _check(dtw_band_cuda(a, b, w, c, row_block=R, stream=True,
                                 form="cluster", cluster=n),
                   ref.dtw_band_ref(a, b, w, c, row_block=R), exact=True)
    for bad in (1, 9):
        with pytest.raises(ValueError, match="blocks"):
            dtw_band_cuda(a, b, L, stream=True, form="cluster", cluster=bad)
    wide = _rand(dev, 63, 1, 65536)
    with pytest.raises(ValueError, match="blocks"):
        dtw_band_cuda(wide, wide, 65536, stream=True, cluster=2)


def test_envelope_kernel_long_series_full_window(dev):
    x = _rand(dev, 17, 3, 65536)
    for w in (655, 65536):
        u, lo = envelope_cuda(x, w)
        ru, rlo = ref.envelope_ref(x, w)
        _check(u, ru, exact=True)
        _check(lo, rlo, exact=True)


def test_nn_search_routes_long_full_window_dtw_to_the_stream_kernel(dev):
    """L = 14500, w = L on a small store: every DTW of the search runs in
    K5 (K4 never launches), and ids and distances equal the card's brute
    force."""
    ds = make_dataset(n_classes=2, n_train_per_class=8, n_test_per_class=1,
                      length=14500, seed=5)
    L = ds.length
    cfg = EngineConfig(cascade=CascadeConfig(w=L, v=4), verify_chunk=4, k=1)
    idx = build_index(ds.x_train, L, ds.y_train, device=dev)
    _build.reset_counts()
    res = nn_search(idx, ds.x_test, cfg)
    counts = _build.counts()
    assert counts["dtw_band_stream"] > 0 and counts["dtw_band"] == 0
    assert counts["dtw_band_slots"] == 0 and counts["dtw_band_block"] == 0
    bd, bi = brute_force(idx, ds.x_test, L, k=1)
    assert torch.equal(bi, res.idx) and torch.equal(bd, res.dists)


def test_wrappers_count_launches_and_refuse_bad_input(dev):
    _build.reset_counts()
    x = _rand(dev, 10, 4, 32)
    envelope_cuda(x, 3)
    dtw_band_cuda(x, x, 3)
    dtw_band_cuda(x, x, 3, torch.zeros(4, device=dev))
    assert _build.counts() == {"envelope": 1, "lb_enhanced": 0,
                               "lb_enhanced_full": 0,
                               "lb_enhanced_pairwise": 0, "dtw_band": 2,
                               "dtw_band_slots": 0,
                               "dtw_band_block": 0, "dtw_band_stream": 0,
                               "dtw_band_stream_cluster": 0,
                               "dtw_band_stream_scratch": 0,
                               "dtw_band_step": 0, "dtw_band_step_slots": 0,
                               "dtw_band_step_block": 0, "sketch_bound": 0,
                               "lb_keogh": 0, "flash_attention": 0,
                               "flash_attention_f32": 0,
                               "mamba_scan": 0, "mamba_scan_wide": 0}
    with pytest.raises(ValueError, match="float32"):
        dtw_band_cuda(x.double(), x.double(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        envelope_cuda(x.t(), 3)
    with pytest.raises(ValueError, match="shape"):
        dtw_band_cuda(x, x[:3], 3)
    long = _rand(dev, 11, 1, 40000)
    with pytest.raises(ValueError, match="shared memory"):
        dtw_band_cuda(long, long, 40000)
    with pytest.raises(ValueError, match="expected one of"):
        dtw_band_cuda(x, x, 3, form="rows")
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
    assert all(_build.counts()[name] > 0 for name in
               ("lb_enhanced", "lb_enhanced_pairwise", "dtw_band"))
    want = nn_search(cpu_idx, ds.x_test, cfg, plan=plan)
    assert torch.equal(res.idx.cpu(), want.idx)
    assert torch.equal(res.n_dtw.cpu(), want.n_dtw)
    assert torch.equal(res.dists.cpu(), want.dists)
    bd, bi = brute_force(gpu_idx, ds.x_test, w, k=k)
    assert torch.equal(bi, res.idx) and torch.equal(bd, res.dists)
    np.testing.assert_array_equal(gpu_idx.upper.cpu().numpy(),
                                  cpu_idx.upper.numpy())


@pytest.mark.parametrize("Q,N,S", [(3, 37, 16), (33, 200, 16), (5, 129, 7),
                                   (1, 1, 1), (70, 65, 40), (2, 300, 256)])
def test_sketch_bound_kernel_bit_equal(dev, Q, N, S):
    g = torch.Generator().manual_seed(12)
    qs = (torch.randn(Q, S, generator=g) * 60).to(dev)
    lo = torch.randint(-127, 100, (N, S), generator=g, dtype=torch.int8)
    hi = torch.clamp(lo.to(torch.int32) + torch.randint(
        0, 40, (N, S), generator=g), max=127).to(torch.int8)
    wseg = (torch.rand(S, generator=g) * 0.3).to(dev)
    got = sketch_bound_cuda(qs, lo.to(dev), hi.to(dev), wseg)
    _check(got, ref.sketch_bound_scaled(qs, lo.to(dev), hi.to(dev), wseg),
           exact=True)
    # a misaligned int8 row start takes the byte path, same values
    lo2 = torch.zeros(N * S + 1, dtype=torch.int8, device=dev)[1:]
    hi2 = torch.zeros(N * S + 1, dtype=torch.int8, device=dev)[1:]
    lo2.copy_(lo.flatten())
    hi2.copy_(hi.flatten())
    _check(sketch_bound_cuda(qs, lo2.view(N, S), hi2.view(N, S), wseg), got,
           exact=True)
    with pytest.raises(ValueError, match="int8"):
        sketch_bound_cuda(qs, lo.to(dev).float(), hi.to(dev), wseg)


# Q, C, L, w: ragged against the kernel's 128 x 64 output tile and its
# 32-column chunks (Q = 129, C = 65, L = 33 straddle them), full interior
# tiles (Q = 256, C = 128, L = 512), L = 17984 (UEA EigenWorms)
LB_KEOGH_SWEEP = [(3, 37, 33, 8), (9, 70, 64, 1), (33, 31, 100, 0),
                  (2, 65, 9, 9), (40, 600, 512, 51), (129, 65, 33, 4),
                  (256, 128, 512, 51), (5, 70, 17984, 179), (1, 1, 1, 0)]


@pytest.mark.parametrize("Q,C,L,w", LB_KEOGH_SWEEP)
def test_lb_keogh_kernel(dev, Q, C, L, w):
    q, c = _rand(dev, 13, Q, L), _rand(dev, 14, C, L)
    u, lo = ref.envelope_ref(c, w)
    _check(lb_keogh_cuda(q, u, lo), ref.lb_keogh_ref(q, u, lo), exact=False)


@pytest.mark.parametrize("Q,C,L,w", [(130, 70, 300, 10), (7, 200, 17984, 50),
                                     (256, 128, 512, 51)])
def test_lb_keogh_kernel_random_walks_and_odd_envelopes(dev, Q, C, L, w):
    """Non-normalised random walks of scale ~100, then envelopes with some
    lo > u, some +inf and -inf bounds and a NaN, to rtol 1e-5, atol 1e-6
    of the plain version, NaN where it has NaN: the chunks that hold such
    an element run the reference's arithmetic in the kernel."""
    g = np.random.default_rng(Q + L)
    q = torch.from_numpy(g.normal(size=(Q, L)).cumsum(1) * 10).float().to(dev)
    c = torch.from_numpy(g.normal(size=(C, L)).cumsum(1) * 10).float().to(dev)
    u, lo = ref.envelope_ref(c, w)
    _check(lb_keogh_cuda(q, u, lo), ref.lb_keogh_ref(q, u, lo), exact=False)
    u, lo = u.clone(), lo.clone()
    u[3, 5] = lo[3, 5] - 25.0                       # lo > u
    lo[4, 7:40] = u[4, 7:40] + 1.0                  # a run of lo > u
    u[5, 100:110] = float("inf")
    lo[6, :L // 2] = float("-inf")
    u[C - 1, L - 1], lo[C - 1, L - 1] = float("inf"), float("-inf")
    lo[C - 2, L // 3] = float("nan")
    got, want = lb_keogh_cuda(q, u, lo), ref.lb_keogh_ref(q, u, lo)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(want[:, C - 2]).all()
    ok = ~torch.isnan(want)
    _check(got[ok], want[ok], exact=False)


def test_sketch_path_on_the_card_equals_the_cpu(dev):
    """``use_sketch`` + ``auto_plan`` + ``mask`` on the card: the live
    mask, the committed plan, ids, n_dtw and distances equal the CPU
    search's, and K7 ran on the path."""
    from repro_torch.search import planner

    ds = make_dataset(n_classes=4, n_train_per_class=64,
                      n_test_per_class=8, length=96, seed=5)
    w = 9
    cfg = EngineConfig(cascade=CascadeConfig(w=w, use_sketch=True),
                       verify_chunk=8, k=1, auto_plan=True)
    out = {}
    for device in ("cpu", dev):
        planner.plan_cache_clear()
        _build.reset_counts()
        idx = build_index(ds.x_train, w, ds.y_train, device=device,
                          calibrate=cfg, mask=True)
        res, stats = nn_search(idx, ds.x_test, cfg, with_stats=True)
        out[str(device)] = (idx, res, stats, _build.counts())
    (ci, cr, cs, _), (gi, gr, gs, counts) = out["cpu"], out[str(dev)]
    assert counts["sketch_bound"] > 0 and counts["dtw_band"] > 0
    assert torch.equal(gi.live.cpu(), ci.live)
    assert torch.equal(gi.sk_lo.cpu(), ci.sk_lo)
    assert gs.plan_tiers == cs.plan_tiers and gs.dropped == cs.dropped
    assert torch.equal(gr.idx.cpu(), cr.idx)
    assert torch.equal(gr.n_dtw.cpu(), cr.n_dtw)
    assert torch.equal(gr.dists.cpu(), cr.dists)
    assert gs.guards.tripped() == () and not gs.degraded
    planner.plan_cache_clear()


# K9 sweep: g in {1, 2, 4, 8}, D in {64, 80, 96, 128, 256} (80: hubert's
# non-causal layer), causal and not, window, cap, ragged and unequal
# Sq / Skv, float32 and bfloat16
FLASH_SWEEP = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window, cap, dtype
    (2, 40, 40, 4, 4, 64, True, None, None, torch.float32),
    (1, 77, 77, 8, 1, 128, True, 16, 30.0, torch.float32),
    (2, 100, 70, 2, 1, 256, False, None, None, torch.float32),
    (1, 33, 90, 8, 4, 64, False, 20, 50.0, torch.float32),
    (2, 129, 129, 16, 2, 128, True, None, 50.0, torch.bfloat16),
    (1, 300, 300, 8, 4, 256, True, 64, 50.0, torch.bfloat16),
    (3, 65, 65, 2, 2, 96, False, None, None, torch.bfloat16),
    (1, 1, 17, 8, 4, 256, False, None, 50.0, torch.float32),
    (2, 100, 100, 4, 4, 80, False, None, None, torch.bfloat16),
    (1, 77, 90, 8, 2, 80, True, 16, 30.0, torch.float32),
]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,cap,dtype",
                         FLASH_SWEEP)
def test_flash_attention_kernel(dev, B, Sq, Skv, Hq, Hkv, D, causal, window,
                                cap, dtype):
    q = _rand(dev, 20, B, Sq, Hq, D).to(dtype)
    k = _rand(dev, 21, B, Skv, Hkv, D).to(dtype)
    v = _rand(dev, 22, B, Skv, Hkv, D).to(dtype)
    got = flash_attention_cuda(q, k, v, causal, window, cap)
    want = ref.flash_attention_ref(q, k, v, causal, window, cap)
    assert got.dtype == dtype and got.shape == want.shape
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
           else dict(rtol=1e-2, atol=1e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,cap,dtype",
                         FLASH_SWEEP)
def test_flash_attention_bf16_form_over_the_sweep(dev, B, Sq, Skv, Hq, Hkv,
                                                  D, causal, window, cap,
                                                  dtype):
    """Every sweep shape in bfloat16 (D = 96, g = 8, ragged and unequal
    Sq / Skv, window, cap): the tensor-core form, within bf16's
    tolerance, launched under its own count (the f32 form's stays 0)."""
    q = _rand(dev, 20, B, Sq, Hq, D).bfloat16()
    k = _rand(dev, 21, B, Skv, Hkv, D).bfloat16()
    v = _rand(dev, 22, B, Skv, Hkv, D).bfloat16()
    _build.reset_counts()
    got = flash_attention_cuda(q, k, v, causal, window, cap)
    assert _build.counts()["flash_attention"] == 1
    assert _build.counts()["flash_attention_f32"] == 0
    want = ref.flash_attention_ref(q, k, v, causal, window, cap)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


# K10 sweep: N in {4, 16, 17, 32, 64, 128, 256}, S and C multiples of no
# tile, nonzero h0
MAMBA_SWEEP = [(2, 33, 70, 4), (3, 100, 300, 16), (1, 17, 129, 64),
               (2, 1, 5, 16), (1, 50, 128, 32), (2, 40, 33, 17),
               (1, 70, 40, 128), (1, 40, 33, MAX_STATE)]


def _mamba_args(dev, B, S, C, N):
    g = torch.Generator().manual_seed(23)
    delta = (torch.rand(B, S, C, generator=g) * 0.1).to(dev)
    u = _rand(dev, 24, B, S, C)
    A = (-torch.rand(C, N, generator=g) * 3).to(dev)
    Bm, Cm = _rand(dev, 25, B, S, N), _rand(dev, 26, B, S, N)
    h0 = _rand(dev, 27, B, C, N)
    return delta, u, A, Bm, Cm, h0


@pytest.mark.parametrize("B,S,C,N", MAMBA_SWEEP)
def test_mamba_scan_kernel(dev, B, S, C, N):
    args = _mamba_args(dev, B, S, C, N)
    y, h = mamba_scan_cuda(*args)
    ry, rh = ref.mamba_scan_ref(*args)
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(h, rh, rtol=1e-5, atol=1e-6)
    assert torch.equal(y, ry) and torch.equal(h, rh)


@pytest.mark.parametrize("B,S,C,N", [(1, 40, 33, MAX_STATE + 1),
                                     (2, 37, 70, 512), (1, 20, 9, 1024)])
def test_mamba_scan_wide_state_form(dev, B, S, C, N):
    """Past 256 states the wide-state form (passes of 256 states, each
    step's sum carried through y) is bit-equal to the plain version, under
    one ``mamba_scan_wide`` count and none of ``mamba_scan``."""
    args = _mamba_args(dev, B, S, C, N)
    _build.reset_counts()
    y, h = mamba_scan_cuda(*args)
    assert _build.counts()["mamba_scan_wide"] == 1
    assert _build.counts()["mamba_scan"] == 0
    ry, rh = ref.mamba_scan_ref(*args)
    assert torch.equal(y, ry) and torch.equal(h, rh)


def test_lm_kernel_wrappers_count_and_refuse(dev):
    _build.reset_counts()
    q = _rand(dev, 30, 1, 8, 4, 64)
    kv = _rand(dev, 31, 1, 8, 2, 64)
    flash_attention_cuda(q, kv, kv)
    args = [_rand(dev, 32, 1, 6, 8), _rand(dev, 33, 1, 6, 8),
            -_rand(dev, 34, 8, 4).abs(), _rand(dev, 35, 1, 6, 4),
            _rand(dev, 36, 1, 6, 4), _rand(dev, 37, 1, 8, 4)]
    mamba_scan_cuda(*args)
    assert _build.counts()["flash_attention_f32"] == 1
    assert _build.counts()["flash_attention"] == 0
    assert _build.counts()["mamba_scan"] == 1
    with pytest.raises(ValueError, match="gradient"):
        flash_attention_cuda(q.requires_grad_(), kv, kv)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_cuda(q.detach().half(), kv.half(), kv.half())
    # a head dim past 256 runs the same f32-arithmetic form, one count
    big = _rand(dev, 38, 1, 4, 2, 320)
    torch.testing.assert_close(flash_attention_cuda(big, big, big),
                               ref.flash_attention_ref(big, big, big),
                               rtol=1e-4, atol=1e-5)
    assert _build.counts()["flash_attention_f32"] == 2
    with pytest.raises(ValueError, match="gradient"):
        mamba_scan_cuda(args[0].requires_grad_(), *args[1:])
    # a state past 256 runs the wide-state form under its own count
    wide = [args[0].detach(), args[1], -_rand(dev, 42, 8, 257).abs(),
            _rand(dev, 43, 1, 6, 257), _rand(dev, 44, 1, 6, 257),
            _rand(dev, 45, 1, 8, 257)]
    y, h = mamba_scan_cuda(*wide)
    ry, rh = ref.mamba_scan_ref(*wide)
    assert torch.equal(y, ry) and torch.equal(h, rh)
    assert _build.counts()["mamba_scan_wide"] == 1
    with pytest.raises(ValueError, match="N >= 1"):
        mamba_scan_cuda(wide[0], wide[1], wide[2][:, :0], wide[3][..., :0],
                        wide[4][..., :0], wide[5][..., :0])
    assert _build.counts()["flash_attention_f32"] == 2
    assert _build.counts()["flash_attention"] == 0
    assert _build.counts()["mamba_scan"] == 1
    assert _build.counts()["mamba_scan_wide"] == 1


@pytest.mark.parametrize("name,kernel", [("gemma2-2b", "flash_attention_f32"),
                                         ("falcon-mamba-7b", "mamba_scan")])
def test_lm_prefill_on_the_card_equals_the_cpu(dev, name, kernel):
    """A reduced model (f32) on the card through K9 / K10 against the same
    weights on the CPU through the plain versions; each layer launched
    the kernel once."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import LM

    cfg = reduced(ARCHS[name])
    model = LM(cfg, compute_dtype=torch.float32, cache_dtype=torch.float32,
               attn_impl="kernel", ssm_impl="kernel")
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 24),
                           generator=torch.Generator().manual_seed(4))
    want, _, _ = model.prefill(params, {"tokens": tokens})
    on_card = torch.utils._pytree.tree_map(lambda t: t.to(dev), params)
    _build.reset_counts()
    got, _, _ = model.prefill(on_card, {"tokens": tokens.to(dev)})
    assert _build.counts()[kernel] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["g96", "g65_bf16", "d12_bf16", "d100_bf16",
                                  "unaligned_bf16"])
def test_flash_attention_wrapper_repairs(dev, case):
    """Inputs the kernels do not take, run exactly by the wrapper: more
    than 64 query heads per kv head (split into launches of at most 64
    heads of each group), bf16 head dims that are not a multiple of 8
    (zero-padded, the true D's scale, the output cut back), and bf16
    storage that is not 16-byte aligned (an aligned copy).  Each against
    the plain version, at the tolerance of its type."""
    dt = torch.float32 if case == "g96" else torch.bfloat16
    B, Sq, Hkv = 1, 37, 2
    g = {"g96": 96, "g65_bf16": 65}.get(case, 2)
    D = {"d12_bf16": 12, "d100_bf16": 100}.get(case, 64)
    q = _rand(dev, 70, B, Sq, Hkv * g, D).to(dt)
    k = _rand(dev, 71, B, Sq, Hkv, D).to(dt)
    v = _rand(dev, 72, B, Sq, Hkv, D).to(dt)
    if case == "unaligned_bf16":
        # views one element into their storage: 2-byte aligned
        q, k, v = (_rand(dev, 73 + i, x.numel() + 1).to(dt)[1:].view(x.shape)
                   for i, x in enumerate((q, k, v)))
        assert all(x.data_ptr() % 16 for x in (q, k, v))
    _build.reset_counts()
    got = flash_attention_cuda(q, k, v, True, 16, 30.0)
    want = ref.flash_attention_ref(q, k, v, True, 16, 30.0)
    assert got.dtype == dt and got.shape == want.shape
    tol = (dict(rtol=1e-4, atol=1e-5) if dt == torch.float32
           else dict(rtol=1e-2, atol=1e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)
    name = "flash_attention_f32" if dt == torch.float32 else "flash_attention"
    assert _build.counts()[name] == (2 if g > 64 else 1)
    # past D = 256 the f32-arithmetic form runs (no padding, any
    # alignment)
    _build.reset_counts()
    big = _rand(dev, 38, 1, 4, 2, 264).to(dt)
    got = flash_attention_cuda(big, big, big, True, 16, 30.0)
    torch.testing.assert_close(
        got.float(), ref.flash_attention_ref(big, big, big, True, 16,
                                             30.0).float(), **tol)
    assert _build.counts()["flash_attention_f32"] == 1
    assert _build.counts()["flash_attention"] == 0


# ---- slice 7: K2 over the whole store, K7's full tiles, K9's wide form ---

def _lb_plain_cols(q, c, u, lo, w, v, live, bands_only, chunk=512):
    """The plain version over candidate chunks (its full form materialises
    (Q, C, L) intermediates); per pair, so equal to one call."""
    outs = [ref.lb_enhanced_ref(
        q, c[s:s + chunk], u[s:s + chunk], lo[s:s + chunk], w, v,
        live=None if live is None else live[s:s + chunk],
        bands_only=bands_only) for s in range(0, c.shape[0], chunk)]
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("Q,C,L,w,v", [
    (257, 16384 + 37, 512, 51, 4),          # the main store, ragged
    (16, 1024 + 5, 17984, 17984, 4),        # the long path, w = L
    (33, 3000, 512, 51, 8),                 # v = 8: nb = 8
    (40, 700, 64, 0, 4),                    # w = 0: nb = 0
    (20, 900, 30, 30, 20),                  # nb = 15: the generic form
])
@pytest.mark.parametrize("mask", ["none", "dead_tiles"])
def test_lb_enhanced_whole_store_bit_equal(dev, Q, C, L, w, v, mask):
    """K2 at whole-store shapes: bands-only bit-equal to the plain version
    (same -inf positions), the full form to rtol 1e-5, atol 1e-6; with a
    mask, the first two 128-candidate tiles all dead, the third holding
    one survivor, the rest random."""
    q, c = _rand(dev, 80, Q, L), _rand(dev, 81, C, L)
    u, lo = ref.envelope_ref(c, w)
    live = None
    if mask == "dead_tiles":
        live = _rand(dev, 82, C) > -0.5
        live[:384] = False
        live[300] = True                         # a lone survivor
    for bands_only in (True, False):
        got = lb_enhanced_cuda(q, c, u, lo, w, v, live=live,
                               bands_only=bands_only)
        want = _lb_plain_cols(q, c, u, lo, w, v, live, bands_only)
        _check(got, want, exact=bands_only)


def test_bands_tier_is_one_launch_per_call(dev):
    """The kernel route of the cross-block tiers launches K2 once over
    the store, whatever ``candidate_chunk`` (the bands form under its
    count, the full form under ``lb_enhanced_full``); the matrix equals
    the CPU's chunked plain route bit for bit (bands) or to rtol 1e-5
    (full)."""
    from repro_torch.search import cascade

    ds = make_dataset(n_classes=4, n_train_per_class=300,
                      n_test_per_class=4, length=64, seed=6)
    w = 6
    idx = build_index(ds.x_train, w, ds.y_train, device=dev)
    cpu_idx = build_index(ds.x_train, w, ds.y_train, device="cpu")
    cfg = CascadeConfig(w=w, v=4, candidate_chunk=64)
    q = torch.as_tensor(ds.x_test, dtype=torch.float32)
    live = torch.rand(idx.n, generator=torch.Generator().manual_seed(2)) > .3
    for tier, exact, count in (
            (cascade.bands_prefilter, True, "lb_enhanced"),
            (cascade.enhanced_all_pairs, False, "lb_enhanced_full")):
        for lv in (None, live):
            _build.reset_counts()
            got = tier(q.to(dev), idx, cfg,
                       live=None if lv is None else lv.to(dev))
            assert _build.counts()[count] == 1
            assert sum(_build.counts().values()) == 1
            want = tier(q, cpu_idx, cfg, live=lv)
            _check(got.cpu(), want, exact=exact)


@pytest.mark.parametrize("S", [1, 7, 16, 40, 256])
def test_sketch_bound_full_and_ragged_tiles_bit_equal(dev, S):
    """K7 at Q = 257 (sixteen full query tiles and a ragged one), N = 65541,
    bit-equal to the plain version, on aligned storage and on int8
    storage one byte off alignment (the byte path)."""
    Q, N = 257, 65541
    g = torch.Generator().manual_seed(S)
    qs = (torch.randn(Q, S, generator=g) * 60).to(dev)
    lo = torch.randint(-127, 100, (N, S), generator=g, dtype=torch.int8)
    hi = torch.clamp(lo.to(torch.int32) + torch.randint(
        0, 40, (N, S), generator=g), max=127).to(torch.int8)
    lo, hi = lo.to(dev), hi.to(dev)
    wseg = (torch.rand(S, generator=g) * 0.3).to(dev)
    want = ref.sketch_bound_scaled(qs, lo, hi, wseg)
    _build.reset_counts()
    _check(sketch_bound_cuda(qs, lo, hi, wseg), want, exact=True)
    assert _build.counts()["sketch_bound"] == 1
    off = []
    for x in (lo, hi):
        buf = torch.zeros(N * S + 1, dtype=torch.int8, device=dev)[1:]
        buf.copy_(x.flatten())
        off.append(buf.view(N, S))
    assert all(x.data_ptr() % 16 for x in off)
    _check(sketch_bound_cuda(qs, off[0], off[1], wseg), want, exact=True)


# B, Sq, Skv, Hq, Hkv, D, causal, window, cap: g in {1, 2, 8}, causal and
# not, window, cap, ragged and unequal Sq / Skv; f32 at D in {64, 96, 200,
# 256} (clusters of 1 and 2 blocks), both types past 256: one cluster up to
# D = 2048 (16 blocks), column groups past it (D = 2100: 2 groups of 9
# blocks, one owning no columns; D = 4100: 3 groups of 11)
WIDE_SWEEP = [
    (2, 40, 40, 2, 2, 64, True, None, None),
    (1, 77, 77, 8, 4, 96, True, 16, 30.0),
    (1, 100, 70, 8, 1, 200, False, None, 50.0),
    (2, 65, 65, 16, 2, 256, True, None, 50.0),
    (2, 40, 40, 2, 2, 257, True, None, None),
    (1, 77, 77, 8, 4, 320, True, 16, 30.0),
    (1, 100, 70, 8, 1, 512, False, None, 50.0),
    (1, 33, 90, 2, 1, 1024, False, 20, None),
    (2, 65, 65, 16, 2, 320, True, None, 50.0),
    (1, 1, 17, 8, 4, 512, False, None, None),
    (1, 30, 45, 2, 1, 1100, True, 20, 50.0),
    (1, 30, 45, 2, 1, 2048, True, 20, 50.0),
    (1, 17, 33, 2, 2, 2100, False, None, 30.0),
    (1, 20, 20, 4, 2, 4100, True, None, None),
]
WIDE_CASES = [(*case, dt) for case in WIDE_SWEEP
              for dt in (torch.float32, torch.bfloat16)
              if dt == torch.float32 or case[5] > MAX_HEAD_DIM]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window,cap,dtype",
                         WIDE_CASES)
def test_flash_attention_wide_form(dev, B, Sq, Skv, Hq, Hkv, D, causal,
                                   window, cap, dtype):
    """K9's f32-arithmetic form (every f32 call, and bf16 past D = 256)
    against the plain version: f32 to rtol 1e-4, atol 1e-5; bf16 to rtol
    1e-2, atol 1e-2 and a relative RMS error of 1e-2.  One launch of
    ``flash_attention_f32`` and none of ``flash_attention``."""
    q = _rand(dev, 90, B, Sq, Hq, D).to(dtype)
    k = _rand(dev, 91, B, Skv, Hkv, D).to(dtype)
    v = _rand(dev, 92, B, Skv, Hkv, D).to(dtype)
    _build.reset_counts()
    got = flash_attention_cuda(q, k, v, causal, window, cap)
    counts = {n: c for n, c in _build.counts().items() if c}
    assert counts == {"flash_attention_f32": 1}
    want = ref.flash_attention_ref(q, k, v, causal, window, cap)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        g32, w32 = got.float(), want.float()
        torch.testing.assert_close(g32, w32, rtol=1e-2, atol=1e-2)
        rel = ((g32 - w32).square().mean().sqrt()
               / w32.square().mean().sqrt()).item()
        assert rel <= 1e-2


@pytest.mark.parametrize("global_budget", [False, True])
def test_one_rank_nccl_step_equals_nn_search(dev, tmp_path, global_budget):
    """The distributed step on a one-rank NCCL world ((1, 1) mesh) returns
    ``nn_search``'s ids, distances and ``n_dtw`` on the card (one shard:
    the global budget changes no bound), its merged guard vector clean."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.search import (GuardReport, make_distributed_search,
                                    shard_index)

    ds = make_dataset(n_classes=4, n_train_per_class=64,
                      n_test_per_class=8, length=96, seed=5)
    w = 9
    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=4, candidate_chunk=64,
                                             adaptive_budget=False),
                       verify_chunk=8, k=2)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rdv'}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh((1, 1), ("data", "model"))
        idx = build_index(ds.x_train, w, ds.y_train)
        sidx = shard_index(mesh, idx)
        step = make_distributed_search(mesh, cfg, with_guards=True,
                                       global_budget=global_budget)
        _build.reset_counts()
        d, i, n, gv = step(sidx.series, sidx.labels, sidx.upper, sidx.lower,
                           sidx.kim, sidx.kim_ok, ds.x_test)
        assert all(_build.counts()[name] > 0 for name in
                   ("lb_enhanced", "lb_enhanced_pairwise", "dtw_band"))
        want = nn_search(idx, ds.x_test, cfg)
        assert torch.equal(i, want.idx) and torch.equal(d, want.dists)
        assert torch.equal(n, want.n_dtw)
        rep = GuardReport.from_vector(gv)
        assert rep.ok() and rep.values()["conserve_checked"] > 0
    finally:
        dist.destroy_process_group()


# K2's full form: nb = 0 (pure Keogh), 1, 4, 8, 9 (the generic bands) and
# L / 2 (an empty bridge at even L, one column at odd L); L not a multiple
# of 4 or 32; Q < 8, C < 64; two or more 128 x 64 tiles, ragged
K2_FULL_SWEEP = [
    # Q, C, L, w, v
    (5, 37, 33, 8, 0), (3, 70, 66, 1, 4), (130, 150, 100, 10, 4),
    (9, 65, 64, 12, 8), (40, 129, 97, 20, 9), (7, 70, 16, 16, 8),
    (6, 64, 17, 17, 9), (257, 200, 512, 51, 4), (4, 70, 17984, 179, 4),
]


def _odd_envelopes(u, lo):
    """lo > u at a cell and along a run, +-inf bounds, and one NaN."""
    u, lo = u.clone(), lo.clone()
    C, L = u.shape
    u[1, L // 2] = lo[1, L // 2] - 3.0
    lo[2, 1:L - 1] = u[2, 1:L - 1] + 0.5
    u[3, :] = float("inf")
    lo[4, : L // 2] = float("-inf")
    lo[C - 1, L // 3] = float("nan")
    return u, lo


@pytest.mark.parametrize("Q,C,L,w,v", K2_FULL_SWEEP)
def test_lb_enhanced_full_form_sweep(dev, Q, C, L, w, v):
    """The full form against the plain version to rtol 1e-5, atol 1e-6,
    with and without a live mask (its first 64-candidate tile all dead),
    and on envelopes with lo > u, +-inf
    bounds and a NaN (NaN where the plain version has NaN); each call one
    launch of ``lb_enhanced_full`` and none of the bands form."""
    q, c = _rand(dev, 90, Q, L), _rand(dev, 91, C, L)
    u, lo = ref.envelope_ref(c, w)
    live = _rand(dev, 92, C) > -0.5
    live[:64] = False
    if C > 70:
        live[70] = True
    ou, olo = _odd_envelopes(u, lo)
    for uu, ll, lv in ((u, lo, None), (u, lo, live), (ou, olo, None),
                       (ou, olo, live)):
        _build.reset_counts()
        got = lb_enhanced_cuda(q, c, uu, ll, w, v, live=lv)
        assert _build.counts()["lb_enhanced_full"] == 1
        assert sum(_build.counts().values()) == 1
        want = ref.lb_enhanced_ref(q, c, uu, ll, w, v, live=lv)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        _check(got[ok], want[ok], exact=False)
        if lv is not None:
            assert torch.isneginf(got[:, :64]).all()


@pytest.mark.parametrize("Q,C,L,w,v", K2_FULL_SWEEP)
def test_lb_enhanced_full_form_bands_bit_equal_to_the_bands_form(dev, Q, C,
                                                                 L, w, v):
    """With infinite envelopes every bridge term is 0, so the full form is
    its bands alone: bit-equal to the bands form (and to the plain
    bands), live mask and all; at nb = L / 2 with L even the bridge is
    empty and the same holds on the real envelopes."""
    q, c = _rand(dev, 93, Q, L), _rand(dev, 94, C, L)
    inf = torch.full_like(c, float("inf"))
    live = _rand(dev, 95, C) > 0.0
    live[:64] = False
    for lv in (None, live):
        bands = lb_enhanced_cuda(q, c, None, None, w, v, live=lv,
                                 bands_only=True)
        _check(bands, ref.lb_enhanced_ref(q, c, None, None, w, v, live=lv,
                                          bands_only=True), exact=True)
        _check(lb_enhanced_cuda(q, c, inf, -inf, w, v, live=lv), bands,
               exact=True)
    u, lo = ref.envelope_ref(c, w)
    if L % 2 == 0 and min(L // 2, w, v) == L // 2:
        _check(lb_enhanced_cuda(q, c, u, lo, w, v),
               lb_enhanced_cuda(q, c, u, lo, w, v, bands_only=True),
               exact=True)


@pytest.mark.parametrize("Q,C,L,w", LB_KEOGH_SWEEP)
def test_lb_keogh_is_the_full_form_at_v0(dev, Q, C, L, w):
    """K8 and K2's full form share one body (``kg_tile``): at V = 0 the
    full form's output is K8's bit for bit, on real envelopes and on ones
    with lo > u, +-inf bounds and a NaN."""
    q, c = _rand(dev, 96, Q, L), _rand(dev, 97, C, L)
    u, lo = ref.envelope_ref(c, w)
    envs = [(u, lo)] + ([_odd_envelopes(u, lo)] if C >= 5 else [])
    for uu, ll in envs:
        k8 = lb_keogh_cuda(q, uu, ll)
        full = lb_enhanced_cuda(q, c, uu, ll, w, 0)
        assert torch.equal(torch.isnan(k8), torch.isnan(full))
        ok = ~torch.isnan(k8)
        assert torch.equal(k8[ok], full[ok])


def test_unstaged_search_runs_the_full_form(dev):
    """``CascadeConfig(staged=False)`` on the card: the dense plan's
    ``enhanced_dense`` tier is one launch of the full form a search (no
    launch of the bands form), and the neighbours, distances and ``n_dtw``
    equal the same search on the CPU; ids and distances equal the staged
    search's and the brute force's."""
    ds = make_dataset(n_classes=4, n_train_per_class=80,
                      n_test_per_class=8, length=96, seed=12)
    w = 9
    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=4, staged=False),
                       verify_chunk=8, k=1)
    idx = build_index(ds.x_train, w, ds.y_train, device=dev)
    cpu_idx = build_index(ds.x_train, w, ds.y_train, device="cpu")
    _build.reset_counts()
    res = nn_search(idx, ds.x_test, cfg)
    assert _build.counts()["lb_enhanced_full"] == 1
    assert _build.counts()["lb_enhanced"] == 0
    want = nn_search(cpu_idx, ds.x_test, cfg)
    assert torch.equal(res.idx.cpu(), want.idx)
    assert torch.equal(res.n_dtw.cpu(), want.n_dtw)
    assert torch.equal(res.dists.cpu(), want.dists)
    staged = nn_search(idx, ds.x_test, EngineConfig(
        cascade=CascadeConfig(w=w, v=4), verify_chunk=8, k=1))
    assert torch.equal(staged.idx, res.idx)
    assert torch.equal(staged.dists, res.dists)
    bd, bi = brute_force(idx, ds.x_test, w, k=1)
    assert torch.equal(bi, res.idx) and torch.equal(bd, res.dists)


# ---- training: K9 and K10 under autograd on the card ----------------------

def _grads(fn, xs):
    xs = [x.detach().requires_grad_() for x in xs]
    out = fn(*xs)
    out = out if isinstance(out, tuple) else (out,)
    loss = sum(torch.sum(o.float() ** 2) for o in out)
    return torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("dtype,kname", [(torch.bfloat16, "flash_attention"),
                                         (torch.float32,
                                          "flash_attention_f32")])
def test_flash_attention_function_grads_on_the_card(dev, dtype, kname):
    """The op under a gradient launches K9 once (its autograd Function's
    forward) and recomputes the backward through the plain version: its
    gradients against autograd straight through the plain version on the
    card, at K9's forward tolerances by type."""
    xs = [_rand(dev, 60 + i, 2, 96, H, 128).to(dtype)
          for i, H in enumerate((8, 4, 4))]
    args = (True, 32, 50.0)
    _build.reset_counts()
    got = _grads(lambda q, k, v: ops.flash_attention_op(q, k, v, *args), xs)
    assert _build.counts()[kname] == 1
    want = _grads(lambda q, k, v: ref.flash_attention_ref(
        q, k, v, *args, kv_chunk=1024), xs)
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), **tol)


def test_mamba_scan_function_grads_on_the_card(dev):
    """K10 launches once under a gradient; the backward recomputes
    through the chunked scan: against autograd through the chunked scan
    on the card (rtol 1e-3, atol 1e-4, ``tests/test_kernels.py``'s)."""
    from repro_torch.models.mamba import _chunked_selective_scan

    args = _mamba_args(dev, 2, 300, 70, 16)
    _build.reset_counts()
    got = _grads(ops.mamba_scan_op, args)
    assert _build.counts()["mamba_scan"] == 1
    want = _grads(lambda *a: _chunked_selective_scan(*a, chunk=256), args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name,kernel", [("gemma2-2b", "flash_attention_f32"),
                                         ("falcon-mamba-7b", "mamba_scan")])
def test_train_step_on_the_card_equals_the_cpu(dev, name, kernel):
    """A reduced model (f32 compute, remat) on the card through K9 / K10
    against the same model on the CPU through the plain versions: step
    1's loss and gradients (rtol 1e-4, atol 1e-6), then two AdamW steps'
    losses (rtol 1e-4) and parameters (rtol 1e-4, atol 1e-5 on all but
    at most one element in a thousand of a leaf: Adam's first update is
    about g / |g|, so a gradient element near zero, whose relative
    rounding on the two devices differs most, can move by up to ``lr``
    on one and less on the other); the kernel launched twice a layer a
    step (the forward and remat's recompute)."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.data import TokenPipeline
    from repro_torch.models import LM
    from repro_torch.train import OptConfig, init_state, make_train_step
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    cfg = reduced(ARCHS[name])
    model = LM(cfg, compute_dtype=torch.float32, attn_impl="kernel",
               ssm_impl="kernel")
    opt = OptConfig(lr=1e-3, warmup=2)
    step = make_train_step(model, opt)
    batches = [TokenPipeline(cfg.vocab, 2, 24, seed=0).next_batch()
               for _ in range(2)]
    cpu = init_state(model, torch.Generator().manual_seed(5), opt)
    card = tree_map(lambda t: t.to(dev) if isinstance(t, torch.Tensor)
                    else t, cpu)
    (lc, _), gc = value_and_grad(model, cpu.params, batches[0])
    (lk, _), gk = value_and_grad(model, card.params, batches[0])
    torch.testing.assert_close(lk.cpu(), lc, rtol=1e-4, atol=0)
    for g, w in zip(tree_leaves(gk), tree_leaves(gc)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-6)
    losses = {"cpu": [], "card": []}
    for b in batches:
        cpu, m = step(cpu, b)
        losses["cpu"].append(m["loss"].item())
        _build.reset_counts()
        card, m = step(card, b)
        losses["card"].append(m["loss"].item())
        assert _build.counts()[kernel] == 2 * cfg.n_layers
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-4)
    for g, w in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        off = ~torch.isclose(g.cpu(), w, rtol=1e-4, atol=1e-5)
        assert int(off.sum()) <= max(1, w.numel() // 1000)


@pytest.mark.parametrize("name,kernel", [("gemma2-2b", "flash_attention"),
                                         ("falcon-mamba-7b", "mamba_scan")])
def test_serving_launch_counts_unchanged_by_training(dev, name, kernel):
    """A prefill (no gradient recorded, even with parameters that require
    one) launches the kernel once a layer and never enters the autograd
    Functions."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import LM

    cfg = reduced(ARCHS[name])
    model = LM(cfg, attn_impl="kernel", ssm_impl="kernel")
    params = model.init(torch.Generator(device=dev).manual_seed(6))
    params = torch.utils._pytree.tree_map(lambda t: t.requires_grad_(),
                                          params)
    tokens = torch.randint(0, cfg.vocab, (2, 24), device=dev)
    entered = []
    real = (ops._FlashAttention.apply, ops._MambaScan.apply)
    ops._FlashAttention.apply = lambda *a: entered.append(a) or real[0](*a)
    ops._MambaScan.apply = lambda *a: entered.append(a) or real[1](*a)
    try:
        _build.reset_counts()
        logits, _, _ = model.prefill(params, {"tokens": tokens})
    finally:
        ops._FlashAttention.apply, ops._MambaScan.apply = real
    assert _build.counts()[kernel] == cfg.n_layers and not entered
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("n_real,top_k,cf,n_shared", [(8, 2, 8.0, 0),
                                                      (60, 4, 1.25, 2),
                                                      (8, 2, 0.25, 0)])
def test_moe_apply_on_the_card_equals_the_cpu(dev, n_real, top_k, cf,
                                              n_shared):
    """``moe_apply`` in f32 on the card against the CPU: the same experts
    chosen (ids equal) and outputs and aux within rtol 1e-5, atol 1e-5,
    with padded experts (60 of 64), shared experts and capacity drops."""
    from repro_torch.models.moe import moe_apply, moe_init, route

    E = -(-n_real // 16) * 16
    p = moe_init(torch.Generator().manual_seed(7), "cpu", 64, 96, E,
                 n_shared, "silu")
    x = torch.randn(2, 48, 64, generator=torch.Generator().manual_seed(8))
    kw = dict(top_k=top_k, n_real=n_real, act="silu", capacity_factor=cf)
    want = moe_apply(p, x, **kw)
    on_card = torch.utils._pytree.tree_map(lambda t: t.to(dev), p)
    got = moe_apply(on_card, x.to(dev), **kw)
    ids_cpu = route(x.reshape(-1, 64), p["router"], top_k, n_real)[3]
    ids_card = route(x.reshape(-1, 64).to(dev), on_card["router"], top_k,
                     n_real)[3]
    assert torch.equal(ids_card.cpu(), ids_cpu)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)
    # repeatable on the card: no atomics in the combine
    again = moe_apply(on_card, x.to(dev), **kw)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "deepseek-moe-16b",
                                  "jamba-1.5-large-398b", "qwen2-vl-72b",
                                  "hubert-xlarge"])
def test_moe_vlm_audio_prefill_on_the_card_equals_the_cpu(dev, name):
    """A reduced MoE, hybrid, VLM or audio model (f32) on the card through
    K9 (and K10 for jamba) against the same weights on the CPU through the
    plain versions (rtol 1e-4, atol 1e-4); K9's f32 form launched once an
    attention layer, K10 once a Mamba layer."""
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import LM

    cfg = reduced(ARCHS[name])
    model = LM(cfg, compute_dtype=torch.float32, cache_dtype=torch.float32,
               attn_impl="kernel", ssm_impl="kernel")
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    gen = torch.Generator().manual_seed(4)
    if cfg.embed_inputs:
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 24),
                                         generator=gen)}
    else:
        batch = {"frames": torch.randn(2, 24, cfg.d_model, generator=gen)}
    if cfg.vision_prefix:
        batch["vision_embeds"] = torch.randn(2, cfg.vision_prefix,
                                             cfg.d_model, generator=gen)
        batch["positions"] = torch.arange(24).expand(2, 3, 24)
    want, _, _ = model.prefill(params, batch)
    on_card = torch.utils._pytree.tree_map(lambda t: t.to(dev), params)
    _build.reset_counts()
    got, _, _ = model.prefill(on_card, {k: v.to(dev)
                                        for k, v in batch.items()})
    mixers = [cfg.layer_spec(i).mixer for i in range(cfg.n_layers)]
    assert _build.counts()["flash_attention_f32"] == mixers.count("attn")
    assert _build.counts()["mamba_scan"] == mixers.count("mamba")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_dryrun_state_bytes_equal_the_cards(dev):
    """The dry-run's state bytes (``launch.dryrun``, traced on the meta
    device over a one-rank fake world) for train-gemma at 2 layers, full
    width, AdamW, equal the sum of ``nbytes`` of the same state built on
    the card."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.train import OptConfig, init_state
    from repro_torch.tree import tensors

    cfg = dataclasses.replace(ARCHS["gemma2-2b"], n_layers=2)
    state = init_state(LM(cfg), torch.Generator(device=dev).manual_seed(0),
                       OptConfig())
    card = sum(t.nbytes for t in tensors((state.params, state.opt)))
    del state
    with dryrun.fake_world(1):
        mesh = make_host_mesh((1, 1), ("data", "model"), device_type="meta")
        cell = dryrun.build_cell(cfg, ShapeConfig("t", 8192, 1, "train"),
                                 mesh, AxisRules.for_mesh(mesh))
        pred = dryrun.local_bytes((cell.args[0].params, cell.args[0].opt))
    assert dryrun.opt_config_for(cfg).name == OptConfig().name == "adamw"
    assert pred == card


@pytest.mark.parametrize("window", [4096, None])
def test_flash_attention_at_32768(dev, window):
    """K9's bf16 form at gemma2-2b's prefill_32k length on one (batch row,
    head) slice (Hq = Hkv = 1, D = 256, cap 50), a local layer's window of
    4096 and a global layer's, against its plain version to the bf16
    tolerance (rtol 1e-2, atol 1e-2) and a relative RMS error of 1e-2."""
    S, D = 32768, 256
    q, k, v = (_rand(dev, 60 + i, 1, S, 1, D).to(torch.bfloat16)
               for i in range(3))
    _build.reset_counts()
    got = flash_attention_cuda(q, k, v, True, window, 50.0)
    assert _build.counts()["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, True, window, 50.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)
    rel = ((got.float() - want.float()).square().mean().sqrt()
           / want.float().square().mean().sqrt()).item()
    assert rel <= 1e-2


def test_mamba_scan_at_524288_bit_equal(dev):
    """K10 at long_500k's length, S = 524288, on 64 channels (N = 16):
    bit-equal to its plain version, y and the final state."""
    args = _mamba_args(dev, 1, 524288, 64, 16)
    y, h = mamba_scan_cuda(*args)
    ry, rh = ref.mamba_scan_ref(*args)
    assert torch.equal(y, ry) and torch.equal(h, rh)


def test_sizing_predicts_the_train_moe_steps_peak(dev):
    """``launch.dryrun.fit_cell``'s sizing of qwen2-moe-a2.7b's
    ``train_4k`` (train-moe: depth, then batch, on a one-rank fake world)
    within half the card: one step at that size on the card (bf16, remat,
    K9, the optimizer the dry-run traced) peaks at most 1 / 0.95 of the
    prediction (``chip_smoke.py``'s ``DRYRUN_PEAK_MIN``) above what was
    resident, and the predicted state bytes are the card's."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import SHAPES
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed.sharding import AxisRules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import LM
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import tensors

    cfg, shape = ARCHS["qwen2-moe-a2.7b"], SHAPES["train_4k"]
    resident = torch.cuda.memory_allocated()
    budget = 0.5 * torch.cuda.mem_get_info()[1] - resident
    with dryrun.fake_world(1):
        mesh = make_host_mesh((1, 1), ("data", "model"), device_type="meta")
        rules = AxisRules.for_mesh(mesh)
        sz = dryrun.fit_cell(cfg, shape, budget, mesh, rules,
                             vary="depth")
        assert sz["fits"] and sz["predicted_peak"] <= budget
        cell = dryrun.build_cell(sz["cfg"], sz["shape"], mesh, rules)
        pred_state = dryrun.local_bytes((cell.args[0].params,
                                         cell.args[0].opt))
        del cell
    model = LM(sz["cfg"], attn_impl="kernel")
    opt = dryrun.opt_config_for(cfg)
    state = init_state(model, torch.Generator(device=dev).manual_seed(0),
                       opt)
    assert sum(t.nbytes for t in tensors((state.params, state.opt))) \
        == pred_state
    batch = TokenPipeline(sz["cfg"].vocab, sz["shape"].global_batch,
                          shape.seq_len, seed=0).next_batch()
    step = make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    state, metrics = step(state, batch)
    assert np.isfinite(metrics["loss"].item())
    card = torch.cuda.max_memory_allocated() - resident
    assert _build.counts()["flash_attention"] == 2 * sz["cfg"].n_layers
    assert sz["predicted_peak"] >= 0.95 * card
