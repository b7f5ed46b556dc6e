"""The port's public surface against the JAX package's: the distance,
envelope, data and cascade functions that ``repro.core``,
``repro.data`` and ``repro.search`` export, and the two packages'
``__init__`` exports.

The same numpy inputs (from a seed) go to both packages.  Tolerances:
``envelope_naive`` and ``random_pairs`` are exact (max, min and numpy's
own stream); ``squared_euclidean`` sums in another order (rtol 1e-6);
``squared_euclidean_matrix`` differs in its matrix product's rounding
(rtol 1e-5, atol 1e-4, on distances of order 100); ``staged_bounds`` at
the tolerances of ``tests/test_cutoff.py::test_staged_bounds_below_true_distance``
(XLA contracts the DTW cell update into an FMA on the CPU, the port keeps
it unfused).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.kernels as jkernels
import repro_torch.core as core
from repro.data import random_pairs as j_random_pairs
from repro.search import CascadeConfig as JCascadeConfig
from repro.search import build_index as j_build_index
from repro.search import staged_bounds as j_staged_bounds
from repro_torch.data import make_dataset, random_pairs
from repro_torch.search import CascadeConfig, build_index, staged_bounds

ROOT = Path(__file__).resolve().parents[1]


def _series(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_core_exports_every_name_of_the_reference():
    assert set(jcore.__all__) <= set(dir(core))
    assert set(jcore.__all__) <= set(core.__all__)
    assert core.BOUND_NAMES == jcore.BOUND_NAMES


def test_kernels_export_the_seven_ops_lazily():
    """``repro_torch.kernels`` re-exports the reference's seven ``*_op``
    dispatchers, and importing the package loads none of its kernel
    modules (a fresh interpreter, as on a machine without CUDA)."""
    import repro_torch.kernels as kernels
    from repro_torch.kernels import ops

    assert sorted(kernels.__all__) == sorted(jkernels.__all__)
    for name in kernels.__all__:
        assert getattr(kernels, name) is getattr(ops, name)
        assert name in dir(kernels)
    with pytest.raises(AttributeError):
        kernels.no_such_op
    code = ("import sys, repro_torch.kernels as k; "
            "assert 'repro_torch.kernels.ops' not in sys.modules; "
            "assert 'repro_torch.kernels.dtw_band' not in sys.modules; "
            "k.dtw_band_op; assert 'repro_torch.kernels.ops' in sys.modules")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


@pytest.mark.parametrize("shape", [(64,), (5, 64), (3, 4, 33)])
def test_squared_euclidean_matches_jax(shape):
    a, b = _series(0, *shape), _series(1, *shape)
    got = core.squared_euclidean(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(jcore.squared_euclidean(jnp.asarray(a),
                                              jnp.asarray(b)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # it is DTW at window 0
    if len(shape) == 2:
        np.testing.assert_allclose(
            got.numpy(),
            core.dtw_batch(torch.from_numpy(a), torch.from_numpy(b),
                           0).numpy(), rtol=1e-5)


@pytest.mark.parametrize("Q,C,L", [(7, 11, 64), (1, 30, 33), (16, 16, 128)])
def test_squared_euclidean_matrix_matches_jax(Q, C, L):
    q, c = _series(2, Q, L), _series(3, C, L)
    q[0] = c[0]                                   # a zero distance
    got = core.squared_euclidean_matrix(torch.from_numpy(q),
                                        torch.from_numpy(c)).numpy()
    want = np.asarray(jcore.squared_euclidean_matrix(jnp.asarray(q),
                                                     jnp.asarray(c)))
    assert got.shape == (Q, C) and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    direct = ((q[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got, direct, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("L,w", [(8, 1), (16, 0), (16, 16), (33, 7),
                                 (100, 99), (5, 2), (64, 70)])
def test_envelope_naive_matches_jax_exactly(L, w):
    b = _series(4, 3, L)
    u, lo = core.envelope_naive(torch.from_numpy(b), w)
    ju, jlo = jcore.envelope_naive(jnp.asarray(b), w)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    # and the oracle agrees with the prefix-doubling envelope
    eu, elo = core.envelope(torch.from_numpy(b), w)
    assert torch.equal(u, eu) and torch.equal(lo, elo)


@pytest.mark.parametrize("n,L,seed", [(10, 64, 1), (3, 17, 0), (1, 512, 7)])
def test_random_pairs_bit_equal_to_jax(n, L, seed):
    a, b = random_pairs(n, L, seed=seed)
    ja, jb = j_random_pairs(n, L, seed=seed)
    assert a.dtype == ja.dtype == np.float32 and a.shape == (n, L)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)


@pytest.mark.parametrize("w,k", [(8, 2), (0, 1)])
def test_staged_bounds_match_jax(w, k):
    """``staged_bounds`` (the default staged plan through ``run_plan``)
    gives JAX's seeds and bounds on the same store, and its bounds stay
    below the true DTW."""
    ds = make_dataset(n_classes=3, n_train_per_class=12, n_test_per_class=4,
                      length=48, seed=0)
    idx = build_index(ds.x_train, w, ds.y_train, device="cpu")
    jidx = j_build_index(ds.x_train, w, ds.y_train, sketch=None)
    q = ds.x_test
    res = staged_bounds(torch.from_numpy(q), idx,
                        CascadeConfig(w=w, v=4, candidate_chunk=16), k=k)
    jres = j_staged_bounds(jnp.asarray(q), jidx,
                           JCascadeConfig(w=w, v=4, candidate_chunk=16,
                                          use_pallas=False), k=k)
    np.testing.assert_array_equal(res.seed_idx.numpy(),
                                  np.asarray(jres.seed_idx))
    np.testing.assert_allclose(res.seed_d.numpy(), np.asarray(jres.seed_d),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res.lb.numpy(), np.asarray(jres.lb),
                               rtol=1e-4, atol=1e-4)
    dm = core.dtw_pairs(torch.from_numpy(q), idx.series, w).numpy()
    assert np.all(res.lb.numpy() <= dm * (1 + 1e-4) + 1e-4)
    qi = np.arange(dm.shape[0])[:, None]
    np.testing.assert_allclose(res.seed_d.numpy(),
                               dm[qi, res.seed_idx.numpy()], rtol=1e-4,
                               atol=1e-5)


def test_search_exports_every_name_of_the_reference_but_preflight_shard_map():
    """``repro_torch.search`` exports the reference's names, distributed
    search included; ``preflight_shard_map`` works around a jax bug."""
    import repro.search as jsearch
    import repro_torch.search as search

    want = set(jsearch.__all__) - {"preflight_shard_map"}
    assert want <= set(search.__all__)
    assert all(hasattr(search, name) for name in search.__all__)
    assert "preflight_shard_map" not in dir(search)


def test_paper_search_config_is_the_reference_data():
    import dataclasses

    from repro.configs import paper_dtw as jpaper
    from repro_torch.configs import ARCHS, paper_dtw

    assert (dataclasses.asdict(paper_dtw.PAPER_SEARCH)
            == dataclasses.asdict(jpaper.PAPER_SEARCH))
    assert paper_dtw.PAPER_SEARCH.n_store == 2 ** 20
    assert paper_dtw.PAPER_SEARCH.name not in ARCHS


def test_distributed_modules_and_examples_import_no_jax():
    """The slice's modules load neither JAX nor the JAX package, and the
    examples import neither (their import statements, read from source)."""
    import ast

    code = (
        "import sys, repro_torch.search.distributed, repro_torch.launch.mesh, "
        "repro_torch.configs.paper_dtw, repro_torch.testing.faults, "
        "repro_torch.train, repro_torch.data.tokens, "
        "repro_torch.distributed.compression, repro_torch.models.convert, "
        "repro_torch.launch.dryrun, repro_torch.launch.report, "
        "repro_torch.launch.cost_analysis; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]; "
        "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    scripts = sorted((ROOT / "examples_torch").glob("*.py"))
    assert [p.name for p in scripts] == [
        "distributed_search.py", "quickstart.py", "train_lm.py",
        "ucr_classification.py"]
    for path in scripts + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (path.name, name)


def test_make_host_mesh_refuses_without_a_world_or_a_card(monkeypatch):
    """The mesh needs a ``torch.distributed`` world, and a ``"cuda"`` mesh
    (the default) a card: no fallback to the CPU."""
    from repro_torch.launch import make_host_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh((1, 1), ("data", "model"), device_type="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="device_type"):
        make_host_mesh((1,), ("data",), device_type="tpu")
