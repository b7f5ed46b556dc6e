"""The port's sharding rules, mesh planning and heartbeats against the JAX
package's, structurally (no ranks needed, apart from one 1-rank gloo
world).

The rules run on the mesh stubs of ``tests/test_sharding_rules.py``: the
(16, 16) ``("data", "model")`` pod and the (2, 16, 16) two-pod mesh.  For
every architecture the port's ``param_spec`` must equal JAX's on the
reference's stacked tree (``jax.eval_shape`` of ``LM.init``) and, on the
port's per-layer names, JAX's spec without the leading repeat entry (the
rule the port applies to a layer's tensor), with ``serve=False`` and
``True``; the three invariants of that file must hold for the port's
per-layer and stacked leaves; ``batch_specs``, ``cache_shardings`` and
``activation_spec`` equal JAX's on every shape cell; ``plan_mesh`` equals
JAX's for every count up to 512.  Specs are compared as tuples
(``tuple(PartitionSpec)``); everything is exact.  About 15 s on one
worker.
"""

import dataclasses
import datetime
import functools
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.registry import ARCHS as J_ARCHS
from repro.distributed import elastic as j_elastic
from repro.distributed import sharding as j_sharding
from repro.models.model import LM as JLM
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.distributed import (AxisRules, Heartbeat, activation_spec,
                                     batch_specs, cache_shardings,
                                     param_shardings, param_spec, plan_mesh)
from repro_torch.distributed.sharding import (NamedSharding, ShardCtx,
                                              placements)
from repro_torch.train.trainer import reference_view
from repro_torch.tree import Stacked


@dataclasses.dataclass(frozen=True)
class MeshStub:
    axis_names: tuple
    _shape: dict

    @property
    def shape(self):
        return self._shape


SINGLE = MeshStub(("data", "model"), {"data": 16, "model": 16})
MULTI = MeshStub(("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16})
MESHES = {"single": SINGLE, "multi": MULTI}


def _keys(path) -> list:
    out = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            out.append(str(k.key))
        elif isinstance(k, jax.tree_util.SequenceKey):
            out.append(k.idx)
    return out


@functools.lru_cache(maxsize=None)
def _jax_shapes(name: str):
    """(keys, shape) of every leaf of JAX's ``LM.init`` for ``name``."""
    shapes = jax.eval_shape(lambda: JLM(cfg=J_ARCHS[name], mesh=None).init(
        jax.random.PRNGKey(0)))
    return [(_keys(p), tuple(leaf.shape))
            for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]]


@dataclasses.dataclass
class Leaf:
    shape: tuple

    @property
    def ndim(self) -> int:
        return len(self.shape)


def _meta(shape) -> torch.Tensor:
    return torch.empty(tuple(shape), device="meta")


def _per_layer(name: str):
    """(JAX keys, JAX shape, the port's per-layer keys, its shape): the
    prelude's leaves as they are, a scanned leaf at each repeat as layer
    ``first_dense + r * len(period) + pos``."""
    cfg = ARCHS[name]
    prelude, period, n_repeat = cfg.layout()
    for keys, shape in _jax_shapes(name):
        if keys[0] == "prelude":
            yield keys, shape, ["layers"] + keys[1:], shape
        elif keys[0] == "scan":
            for r in range(n_repeat):
                i = len(prelude) + r * len(period) + keys[1]
                yield keys, shape, ["layers", i] + keys[2:], shape[1:]
        else:
            yield keys, shape, keys, shape


def _rules(mesh):
    return AxisRules.for_mesh(mesh)


def _jrules(mesh):
    return (j_sharding.AxisRules(dp=("pod", "data"))
            if "pod" in mesh.axis_names else j_sharding.AxisRules())


def _jspec(name, mesh, keys, shape, serve):
    path = tuple(jax.tree_util.DictKey(k) if isinstance(k, str)
                 else jax.tree_util.SequenceKey(k) for k in keys)
    return tuple(j_sharding.param_spec(J_ARCHS[name], mesh, _jrules(mesh),
                                       path, Leaf(shape), serve=serve))


def _axis_product(mesh, entry):
    total = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        total *= 1 if a is None else mesh.shape[a]
    return total


@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_spec_equals_jax(name, mesh, serve):
    """Stacked leaves (JAX's paths and shapes) get JAX's spec; each
    per-layer leaf gets it without the leading repeat entry."""
    m = MESHES[mesh]
    cfg = ARCHS[name]
    for jkeys, jshape, keys, shape in _per_layer(name):
        want = _jspec(name, m, jkeys, jshape, serve)
        got = param_spec(cfg, m, _rules(m), jkeys, Leaf(jshape), serve=serve)
        assert got == want, (jkeys, jshape, got, want)
        layer = param_spec(cfg, m, _rules(m), keys, Leaf(shape), serve=serve)
        assert layer == (want[1:] if jkeys[0] == "scan" else want), (
            keys, shape, layer, want)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_reference_view_specs_equal_jax(name):
    """``param_shardings`` over ``reference_view`` of the port's layout
    (``Stacked`` leaves) gives JAX's stacked specs, path for path."""
    cfg = ARCHS[name]
    jspecs = {tuple(keys): _jspec(name, SINGLE, keys, shape, False)
              for keys, shape in _jax_shapes(name)}
    tree = {"layers": [None] * cfg.n_layers}
    for _, _, keys, shape in _per_layer(name):
        node = tree
        for k in keys[:-1]:
            if isinstance(node, list) and node[k] is None:
                node[k] = {}
            elif isinstance(node, dict):
                node = node.setdefault(k, {}) if not isinstance(
                    k, str) or k != "layers" else node["layers"]
                continue
            node = node[k]
        node[keys[-1]] = _meta(shape)
    view = reference_view(cfg, tree)
    sh = param_shardings(cfg, SINGLE, AxisRules(), view)
    from repro_torch.tree import named_leaves
    got = dict(named_leaves(sh))
    assert len(got) == len(jspecs)
    for keys, want in jspecs.items():
        key = "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                      for k in keys)
        assert got[key].spec == want, (key, got[key].spec, want)


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_port_specs_divide_and_book_each_axis_once(name, mesh):
    m = MESHES[mesh]
    cfg = ARCHS[name]
    for _, jshape, keys, shape in _per_layer(name):
        for k, s in ((keys, shape), (None, jshape)):
            spec = param_spec(cfg, m, _rules(m), k or ["scan", 0] + keys[2:],
                              Leaf(s))
            seen = []
            for dim, entry in zip(s, spec):
                assert dim % _axis_product(m, entry) == 0, (keys, s, spec)
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    if a is not None:
                        assert a not in seen, (keys, spec)
                        seen.append(a)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_port_big_leaves_are_sharded(name):
    """Every per-layer or stacked leaf of 8 MB or more shards on at least
    one axis."""
    cfg = ARCHS[name]
    for jkeys, jshape, keys, shape in _per_layer(name):
        for k, s in ((keys, shape), (jkeys, jshape)):
            if np.prod(s) * 4 < 8 * 2**20:
                continue
            spec = param_spec(cfg, SINGLE, AxisRules(), k, Leaf(s))
            assert np.prod([_axis_product(SINGLE, e) for e in spec]) > 1, (
                name, k, s, spec)


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_batch_cache_activation_specs_equal_jax(name, mesh, monkeypatch):
    m = MESHES[mesh]
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    rules, jrules = _rules(m), _jrules(m)
    # JAX's cache_shardings wraps each spec in a NamedSharding, which wants
    # a real mesh: keep the bare spec
    monkeypatch.setattr(j_sharding, "NamedSharding", lambda mesh, spec: spec)
    for sname, shape in SHAPES.items():
        got = batch_specs(cfg, shape, m, rules)
        want = j_sharding.batch_specs(jcfg, J_SHAPES[sname], m, jrules)
        assert got == {k: tuple(v) for k, v in want.items()}, sname
        for batch in sorted({shape.global_batch, 1, 3}):
            jc = jax.eval_shape(lambda: JLM(cfg=jcfg).init_caches(batch, 8))
            jsh = j_sharding.cache_shardings(jcfg, m, jrules, jc, batch=batch)
            flat = jax.tree_util.tree_flatten_with_path(jc)[0]
            jspecs = jax.tree_util.tree_leaves(
                jsh, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            for (path, leaf), want in zip(flat, jspecs):
                keys = _keys(path)
                g = cache_shardings(cfg, m, rules, {"x": {keys[-1]: _meta(
                    leaf.shape)}}, batch=batch)["x"][keys[-1]]
                assert g.spec == tuple(want), (keys, batch, g.spec, want)
                # the port's per-layer cache leaf: no repeat axis
                if keys[0] == "scan":
                    g1 = cache_shardings(cfg, m, rules, [{keys[-1]: _meta(
                        leaf.shape[1:])}], batch=batch)[0][keys[-1]]
                    assert g1.spec == tuple(want)[1:], (keys, g1.spec)
    for ok in (True, False):
        assert activation_spec(cfg, rules, ok) == tuple(
            j_sharding.activation_spec(jcfg, jrules, ok))


def test_shard_ctx_roles_match_jax_rules():
    """``ShardCtx.spec`` keeps a role only where its axes divide the
    dimension, as JAX's ``con``; ``con`` is a no-op without a mesh."""
    ctx = ShardCtx(mesh=MULTI, dp=("pod", "data"), seq_shard=True)
    assert ctx.spec((64, 8, 48), "dp", "sp", "tp") == (
        ("pod", "data"), None, "model")
    assert ctx.spec((3, 32, 48), "dp", "sp", None) == (None, "model", None)
    assert ShardCtx(mesh=SINGLE).spec((16, 5), "dp", "tp") == ("data", None)
    assert ShardCtx(mesh=SINGLE).spec((16,), "dp") == (
        tuple(j_sharding.P(("data",))))
    x = torch.ones(3)
    assert ShardCtx().con(x, "dp") is x


def test_placements_of_specs():
    from torch.distributed.tensor import Partial, Replicate, Shard

    assert placements(MULTI, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(SINGLE, (None, "data"), partial=("model",)) == (
        Shard(1), Partial())
    assert placements(SINGLE, ()) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        placements(MULTI, (("data", "pod"),))
    with pytest.raises(ValueError):
        placements(SINGLE, ("data", "data"))
    assert NamedSharding(SINGLE, ("data", None)).placements == (
        Shard(0), Replicate())


def test_plan_mesh_equals_jax():
    for pods in (1, 2):
        for n in range(pods, 513):
            got = plan_mesh(n, pods=pods)
            want = j_elastic.plan_mesh(n, pods=pods)
            assert (got.shape, got.axes) == (want.shape, want.axes), (n, pods)
    assert plan_mesh(256) == type(plan_mesh(256))((16, 16), ("data", "model"))
    assert plan_mesh(24, preferred_tp=8).shape == (3, 8)


def test_heartbeat_protocol(tmp_path):
    """beat -> age / is_straggler; the file is the reference's format
    (its ``Heartbeat`` reads the port's beat and the other way round); a
    missing or torn file reads as a straggler."""
    path = str(tmp_path / "hb.json")
    hb = Heartbeat(path, host_id=3)
    assert hb.age() is None and hb.is_straggler(10.0)
    hb.beat(7)
    assert not (tmp_path / "hb.json.tmp").exists()
    age = hb.age()
    assert age is not None and 0 <= age < 5
    assert not hb.is_straggler(60.0)
    assert j_elastic.Heartbeat(path).age() is not None
    import json
    with open(path) as f:
        beat = json.load(f)
    assert beat["host"] == 3 and beat["step"] == 7
    time.sleep(0.05)
    assert hb.is_straggler(0.01)
    j_elastic.Heartbeat(path, host_id=1).beat(9)
    assert not hb.is_straggler(60.0)
    (tmp_path / "hb.json").write_text("{")
    assert hb.age() is None and hb.is_straggler(60.0)


def test_make_production_mesh_raises_in_a_small_world(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh(device_type="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        for multi, n in ((False, 256), (True, 512)):
            with pytest.raises(RuntimeError, match=f"need {n} ranks.*has 1"):
                make_production_mesh(multi_pod=multi, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_stacked_leaf_gets_a_leading_none():
    cfg = ARCHS["gemma2-2b"]
    leaf = Stacked([torch.empty(2304, 2048, device="meta")] * 3)
    assert param_spec(cfg, SINGLE, AxisRules(), ["scan", 0, "attn", "wq"],
                      leaf) == (None, "data", "model")
