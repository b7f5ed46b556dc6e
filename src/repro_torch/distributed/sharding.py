"""Per-architecture sharding rules on a ``DeviceMesh`` (port of
``repro.distributed.sharding``): parameter, activation, batch and cache
specs, their DTensor placements, and the activation constraint helper.

A spec is what JAX's ``PartitionSpec`` is: a tuple with one entry a
dimension, each ``None`` (replicated), a mesh axis name, or a tuple of
names (the dimension split over several axes, the first one major).  The
rules are the reference's, name-based over the parameter tree:

  * ``model`` axis: tensor parallelism (Megatron column/row) for attention
    and MLPs, expert parallelism for MoE, channel parallelism for Mamba
    (no collective inside the recurrence), vocab parallelism for the
    embedding/head where divisible;
  * ``data`` axis: batch DP + FSDP-style parameter/optimizer sharding
    (each parameter is gathered where an op needs it; DTensor's sharding
    propagation does what GSPMD does there);
  * ``pod`` axis (multi-pod): pure DP.

Anything unknown stays replicated.  kv/vocab axes fall back to replication
when not divisible by the tp size (gemma2 kv = 4, hubert vocab = 504), and
an axis whose size does not divide its dimension is dropped.

``placements`` turns a spec into DTensor placements: ``("pod", "data")``
on dimension d is ``Shard(d)`` on both mesh dimensions, which DTensor
splits in mesh order, pod-major, as JAX does.  ``ShardCtx.con`` is
``with_sharding_constraint``: it redistributes a DTensor activation to
its roles' placements.  ``shard_map_compat`` is the port's ``shard_map``:
a ``local_map`` island whose body runs on each rank's local shards.

The rules accept a real ``DeviceMesh`` or any object with ``axis_names``
and a ``shape`` dict (a stub of the 256- or 512-chip production mesh, to
check the rules without that many ranks).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.tree import named_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor
Spec = tuple


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a mesh stub."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, name: str | None) -> int:
    if mesh is None or name is None:
        return 1
    return mesh_axes(mesh).get(name, 1)


def spec_of(*entries) -> Spec:
    """A spec from its entries, normalised as ``PartitionSpec`` normalises
    them: a one-axis tuple is that axis, an empty one None."""
    return tuple(None if e == () else e[0] if isinstance(e, tuple)
                 and len(e) == 1 else e for e in entries)


def _entry_size(mesh, entry) -> int:
    n = 1
    for a in entry if isinstance(entry, tuple) else (entry,):
        n *= _axis_size(mesh, a)
    return n


@dataclasses.dataclass(frozen=True)
class AxisRules:
    fsdp: str | None = "data"
    tp: str | None = "model"
    ep: str | None = "model"
    dp: tuple[str, ...] = ("data",)     # batch axes (('pod','data') multi-pod)

    @staticmethod
    def for_mesh(mesh) -> "AxisRules":
        if "pod" in axis_names(mesh):
            return AxisRules(dp=("pod", "data"))
        return AxisRules()


def _path_names(path) -> list[str]:
    """The names along a tree path: a sequence of keys (dict keys as
    strings, list indices as ints) or a ``jax.tree_util.keystr``-style
    string such as ``"['layers'][3]['attn']['wq']"``."""
    if isinstance(path, str):
        return [m.group(1) if m.group(1) is not None else f"[{m.group(2)}]"
                for m in re.finditer(r"\['([^']*)'\]|\[(\d+)\]", path)]
    return [k if isinstance(k, str) else f"[{k}]" for k in path]


def param_spec(cfg: ArchConfig, mesh, rules: AxisRules, path, leaf, *,
               serve: bool = False) -> Spec:
    """The spec of the parameter at ``path`` with ``leaf``'s shape (a
    tensor, a ``Stacked`` leaf, or anything with ``.shape``).  A leaf with
    one axis more than its rule (the reference's scanned layout, or
    ``train.trainer.reference_view``'s ``Stacked`` leaves) gets a leading
    ``None``.  ``serve=True`` is weight-stationary inference sharding:
    weights live TP-sharded over ``model`` only and are never gathered."""
    names = _path_names(path)
    name = names[-1]
    shape = tuple(leaf.shape)
    tp = rules.tp if _axis_size(mesh, rules.tp) > 1 else None
    fsdp = rules.fsdp if _axis_size(mesh, rules.fsdp) > 1 else None
    if serve:
        fsdp = None          # weight-stationary: no gather-on-use sharding
    ep = rules.ep if _axis_size(mesh, rules.ep) > 1 else None
    tp_size = _axis_size(mesh, rules.tp)
    kv_ok = cfg.n_kv_heads % max(tp_size, 1) == 0
    vocab_ok = cfg.vocab % max(tp_size, 1) == 0
    in_moe = "moe" in names

    if name in ("wq",):
        spec = (fsdp, tp)
    elif name in ("wk", "wv"):
        spec = (fsdp, tp if kv_ok else None)
    elif name in ("wi", "wg"):
        spec = (ep, fsdp, None) if in_moe else (fsdp, tp)
    elif name == "wo":
        spec = (ep, None, fsdp) if in_moe else (tp, fsdp)
    elif name == "in_proj":
        spec = (fsdp, tp)
    elif name == "out_proj":
        spec = (tp, fsdp)
    elif name == "x_proj":
        spec = (tp, None)
    elif name == "dt_proj":
        spec = (None, tp)
    elif name == "A_log":
        spec = (tp, None)
    elif name == "conv_w":
        spec = (None, tp)
    elif name in ("D", "dt_bias", "conv_b"):
        spec = (tp,)
    elif name == "router":
        spec = (fsdp, None)
    elif name == "embed":
        spec = (tp if vocab_ok else None, fsdp)
    elif name == "head":
        spec = (fsdp, tp if vocab_ok else None)
    elif name == "bq":
        spec = (tp,)
    elif name in ("bk", "bv"):
        spec = (tp if kv_ok else None,)
    else:  # norms and anything unrecognised: replicated
        spec = (None,) * len(shape)
    if len(shape) == len(spec) + 1:     # stacked leaf: leading repeat axis
        spec = (None,) + spec
    elif len(shape) == len(spec) - 1:
        # a shared expert's per-layer MLP weight under "moe": the rule is
        # the expert stack's, which the reference applies to the stacked
        # leaf (its repeat axis over ep); a per-layer tensor cannot live on
        # a subset of the ranks, so it takes the rest of the spec
        spec = spec[1:]
    if len(shape) != len(spec):
        raise ValueError(f"{names}: shape {shape} does not fit spec {spec}")
    # drop specs on axes whose size does not divide the dimension
    return tuple(None if ax is None or dim % _entry_size(mesh, ax) else ax
                 for dim, ax in zip(shape, spec))


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def placements(mesh, spec: Spec, partial: tuple[str, ...] = ()) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (one a mesh dimension):
    ``Shard(d)`` on each mesh dimension named by dimension d's entry,
    ``Partial()`` on the mesh axes in ``partial`` (a local value that is a
    summand of the whole), ``Replicate()`` elsewhere.  A dimension split
    over several axes must name them in mesh order (DTensor splits in that
    order, as ``PartitionSpec(("pod", "data"))`` splits pod-major)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in
               (entry if isinstance(entry, tuple) else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"axis {names[i]} used twice in {spec}")
            out[i] = Shard(d)
    for a in partial:
        i = names.index(a)
        if out[i] != Replicate():
            raise ValueError(f"axis {a} both shards and sums in {spec}")
        out[i] = Partial()
    return tuple(out)


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart);
    ``placements`` gives its DTensor placements."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: Spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({axis_names(self.mesh)}, {self.spec})"


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def distribute(x: Tensor, sharding: NamedSharding) -> Tensor:
    """``x`` as a DTensor of ``sharding``: a DTensor is redistributed; a
    plain tensor is taken as the whole value, which every rank holds, and
    each rank keeps its shard (no communication)."""
    from torch.distributed.tensor import distribute_tensor

    pl = sharding.placements
    if is_dtensor(x):
        return x if tuple(x.placements) == pl else x.redistribute(
            sharding.mesh, pl)
    return distribute_tensor(x, sharding.mesh, pl, src_data_rank=None)


def placed_as(x: Tensor, like: Tensor) -> Tensor:
    """The DTensor ``x`` redistributed to ``like``'s placements (``x``
    itself when they are the same, or when ``x`` is no DTensor)."""
    if is_dtensor(x) and tuple(x.placements) != tuple(like.placements):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def full(x):
    """The whole value of a DTensor (a collective), anything else as it
    is."""
    return x.full_tensor() if is_dtensor(x) else x


def _with_paths(fn: Callable, tree: Any) -> Any:
    return tree_unflatten(tree, [fn(name, leaf)
                                 for name, leaf in named_leaves(tree)])


def param_shardings(cfg: ArchConfig, mesh, rules: AxisRules, tree: Any, *,
                    serve: bool = False, distribute_leaves: bool = False
                    ) -> Any:
    """A ``NamedSharding`` tree matching ``tree`` (the port's parameters,
    ``reference_view``'s layout of them, or anything of those names with
    ``.shape`` leaves).  With ``distribute_leaves``, ``tree``'s tensors
    (the whole values, the same on every rank) come back as DTensors of
    those shardings instead."""
    shardings = _with_paths(lambda name, leaf: NamedSharding(
        mesh, param_spec(cfg, mesh, rules, name, leaf, serve=serve)), tree)
    if not distribute_leaves:
        return shardings
    return shard_tree(tree, shardings)


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Each tensor of ``tree`` distributed by the matching sharding."""
    return tree_map(distribute, tree, shardings)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh,
                rules: AxisRules) -> dict[str, Spec]:
    """Specs for one input batch of the given shape cell."""
    dp_size = _entry_size(mesh, tuple(rules.dp))
    b_ok = shape.global_batch % dp_size == 0 and shape.global_batch >= dp_size
    bspec = rules.dp if b_ok else None
    specs: dict[str, Spec] = {}
    if cfg.embed_inputs:
        specs["tokens"] = spec_of(bspec, None)
    else:
        specs["frames"] = spec_of(bspec, None, None)
    if shape.kind == "train":
        specs["labels"] = spec_of(bspec, None)
    if cfg.vision_prefix:
        specs["vision_embeds"] = spec_of(bspec, None, None)
        specs["positions"] = spec_of(bspec, None, None)
    return specs


def cache_shardings(cfg: ArchConfig, mesh, rules: AxisRules, cache_tree: Any,
                    *, batch: int) -> Any:
    """Cache shardings: batch-shard KV when divisible, else shard the
    sequence axis over the data axes (long-context decode); SSM channels
    over tp.  ``cache_tree`` is the port's per-layer caches or the
    reference's stacked layout (a leaf with one axis more gets a leading
    ``None``)."""
    dp_size = _entry_size(mesh, tuple(rules.dp))
    b_ok = batch % dp_size == 0 and batch >= dp_size
    tp = rules.tp if _axis_size(mesh, rules.tp) > 1 else None
    tp_size = _axis_size(mesh, rules.tp)
    kv_ok = cfg.n_kv_heads % max(tp_size, 1) == 0
    din_ok = cfg.d_inner_ % max(tp_size, 1) == 0
    dp = tuple(rules.dp)

    def spec_for(path, leaf):
        name = _path_names(path)[-1]
        ndim = len(leaf.shape)
        if name in ("k", "v"):
            if b_ok and kv_ok:
                base = (dp, None, tp, None)
            elif b_ok:
                base = (dp, tp, None, None)
            elif kv_ok:
                base = (None, dp, tp, None)
            else:
                base = (None, dp + ((tp,) if tp else ()), None, None)
        elif name == "h":
            base = ((dp, tp if din_ok else None, None)
                    if b_ok else (None, tp if din_ok else None, None))
        elif name == "conv":
            base = ((dp, None, tp if din_ok else None)
                    if b_ok else (None, None, tp if din_ok else None))
        else:
            base = (None,) * ndim
        if ndim == len(base) + 1:
            base = (None,) + base
        return NamedSharding(mesh, spec_of(*base))

    return _with_paths(spec_for, cache_tree)


def activation_spec(cfg: ArchConfig, rules: AxisRules,
                    batch_ok: bool = True) -> Spec:
    """Residual-stream spec: batch over dp; d_model over tp for the very
    wide archs."""
    b = rules.dp if batch_ok else None
    d = rules.tp if cfg.d_model >= 8192 else None
    return spec_of(b, None, d)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Activation-constraint helper threaded through the model layers.

    ``con(x, roles...)`` redistributes the DTensor ``x`` where each role is
    None, "dp" (batch axes), "tp" (tensor axis) or "sp" (the sequence: "tp"
    with ``seq_shard``, else None); a role is dropped when the dimension is
    not divisible by the axis size, so the same model code serves every
    arch (gemma2's kv = 4 heads, hubert's 504-vocab head, batch = 1 all
    degrade to replication instead of erroring).  A plain tensor is taken
    as the whole value, the same on every rank.  ``mesh=None`` makes every
    call a no-op.
    """

    mesh: Any = None
    dp: tuple[str, ...] = ("data",)
    tp: str = "model"
    seq_shard: bool = False   # Megatron-SP: residual stream S over tp

    def size(self, axes) -> int:
        return _entry_size(self.mesh, axes)

    def rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 when it is not in the
        mesh)."""
        if axis not in axis_names(self.mesh):
            return 0
        return self.mesh.get_local_rank(axis)

    def spec(self, shape, *roles) -> Spec:
        if len(shape) != len(roles):
            raise ValueError(f"roles {roles} for shape {tuple(shape)}")
        spec = []
        for dim, role in zip(shape, roles):
            if role == "sp":
                role = "tp" if self.seq_shard else None
            if role == "dp" and self.size(self.dp) > 1 \
                    and dim % self.size(self.dp) == 0:
                spec.append(tuple(self.dp))
            elif role == "tp" and self.size(self.tp) > 1 \
                    and dim % self.size(self.tp) == 0:
                spec.append(self.tp)
            else:
                spec.append(None)
        return spec_of(*spec)

    def con(self, x, *roles):
        if self.mesh is None:
            return x
        return distribute(x, NamedSharding(self.mesh,
                                           self.spec(x.shape, *roles)))


# ---------------------------------------------------------------------------
# islands
# ---------------------------------------------------------------------------

def _grad_placements(in_pl: tuple, outs: list) -> tuple:
    """A replicated input's local gradient is a summand wherever the
    island splits its work over that mesh dimension (some output is
    sharded or partial there): ``Partial`` on those dimensions."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(
        Partial() if p == Replicate() and any(o[m] != Replicate()
                                              for o in outs) else p
        for m, p in enumerate(in_pl))


def shard_map_compat(fn: Callable, *, mesh, in_specs: tuple,
                     out_specs: list) -> Callable:
    """``jax.shard_map``'s counterpart: ``fn`` runs on each rank's local
    shards (``torch.distributed.tensor.experimental.local_map``) and
    returns a tuple, one output an entry of ``out_specs``.

    Each entry of ``in_specs`` / ``out_specs`` is a spec, ``None`` (a
    non-tensor, or a plain tensor passed through as it is), or a tuple of
    DTensor placements (``placements(mesh, spec, partial=...)``: an output
    that is a per-rank summand is ``Partial`` on its mesh axis, where
    ``shard_map`` would ``psum`` inside).  DTensor inputs are redistributed
    to their specs; each input's gradient is declared ``Partial`` on the
    mesh dimensions where it is replicated and the outputs are not, since
    each rank's local gradient is then one summand of the whole.
    """
    from torch.distributed.tensor.experimental import local_map

    def pl(s):
        if s is None:
            return None
        if s and not isinstance(s[0], (str, tuple, type(None))):
            return tuple(s)
        return placements(mesh, s)

    outs = tuple(pl(s) for s in out_specs)
    ins = tuple(pl(s) for s in in_specs)
    tensor_outs = [o for o in outs if o is not None]
    grads = tuple(None if p is None else _grad_placements(p, tensor_outs)
                  for p in ins)
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def scale_grad(x: Tensor, s: float) -> Tensor:
    """``x`` whose gradient is scaled by ``s`` (``s == 1``: ``x`` itself)."""
    return x if s == 1 else _ScaleGrad.apply(x, s)
