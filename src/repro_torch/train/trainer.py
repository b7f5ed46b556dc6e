"""Training loop: train-step builder, gradient accumulation, compression
(port of ``repro.train.trainer``).

The step is eager: ``loss_fn``'s gradients by ``torch.autograd.grad``,
then compression (optional) and the optimizer, in place on the state's
tensors.  Gradient accumulation splits the batch's leading dim into
``(accum, B / accum)`` microbatches, sums their f32 gradients and divides
once, as the reference's scan does.

The optimizer and the compression run on the reference's layout of the
parameters (``reference_view``: each position of the layer period as one
dict of ``Stacked`` per-layer tensors, after the ``first_dense`` prelude
layers), so their per-leaf rules see the leaves the reference sees; the
optimizer state and the compression error are in that layout, one tensor
of the reference's shape a leaf.

Under a mesh (``LM(cfg, mesh=...)``) the state is sharded
(``shard_state``: the parameters by ``param_shardings``, the moments and
the compression error as their parameters in the reference's layout),
each gradient comes back in its parameter's placements, and the step's
metrics are whole (replicated) tensors on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.compression import CompressionConfig, compress_grads
from repro_torch.distributed.sharding import (AxisRules, NamedSharding, full,
                                              param_shardings, placed_as,
                                              shard_tree)
from repro_torch.models.model import LM
from repro_torch.train.optimizer import OptConfig, opt_init, opt_update
from repro_torch.tree import (Stacked, tree_leaves, tree_map, tree_unflatten,
                              zeros_f32)

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt: Any
    err: Any = None          # error-feedback state for compressed grads


def _stack(layers: list) -> Any:
    """One tree of ``Stacked`` leaves from same-structure layer trees."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([l[k] for l in layers]) for k in first}
    return Stacked(list(layers))


def reference_view(cfg: ArchConfig, tree: dict[str, Any]) -> dict[str, Any]:
    """The reference's (``repro.models.model.LM.init``) layout of a tree
    with the port's parameter structure, without a copy: the top-level
    leaves as they are, ``"prelude"`` the first ``first_dense`` layers,
    ``"scan"`` one tree a position of the period whose leaves stack that
    position's repeats."""
    prelude, period, n_repeat = cfg.layout()
    layers = tree["layers"]
    nf, n = len(prelude), len(period)
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["prelude"] = list(layers[:nf])
    out["scan"] = [_stack([layers[nf + r * n + pos] for r in range(n_repeat)])
                   for pos in range(n)]
    return out


def init_state(model: LM, generator: torch.Generator | None,
               opt_cfg: OptConfig, comp: CompressionConfig | None = None,
               device=None) -> TrainState:
    """Parameters from ``model.init(generator, device)`` (default: the
    generator's device, else the card), zero optimizer state and, with
    error feedback, zero compression error."""
    if device is None and generator is not None:
        device = generator.device
    params = model.init(generator, device=resolve_device(device))
    view = reference_view(model.cfg, params)
    err = (tree_map(zeros_f32, view)
           if comp is not None and comp.error_feedback else None)
    return TrainState(step=0, params=params, opt=opt_init(view, opt_cfg),
                      err=err)


def _stats_shardings(sh: NamedSharding, name: str) -> NamedSharding:
    """Adafactor's factored moments keep their parameter's spec on the
    dimensions they keep."""
    spec = sh.spec
    if name == "vr":
        spec = spec[:-1]
    elif name == "vc":
        spec = spec[:-2] + spec[-1:]
    return NamedSharding(sh.mesh, spec)


def state_shardings(cfg: ArchConfig, mesh, rules: AxisRules,
                    state: "TrainState", *, serve: bool = False) -> dict:
    """``NamedSharding`` trees of a state's parts: ``{"params", "opt",
    "err"}`` (``opt`` and ``err`` None when the state has none).  The
    moments and the error follow their parameters in the reference's
    layout (``reference_view``)."""
    params = param_shardings(cfg, mesh, rules, state.params, serve=serve)
    # a stacked moment row r is updated in place with layer r's tensor, so
    # it takes that tensor's placements (a leading None), which for a
    # shared expert's weight is not the reference's stacked spec
    view = tree_map(lambda sh: NamedSharding(
        mesh, (None,) + sh.members[0].spec) if isinstance(sh, Stacked) else sh,
        reference_view(cfg, params))
    opt = None
    if state.opt is not None and "stats" in state.opt:
        opt = {"stats": tree_map(
            lambda sh, st: {k: _stats_shardings(sh, k) for k in st},
            view, state.opt["stats"], is_leaf=lambda x: isinstance(
                x, NamedSharding))}
    elif state.opt is not None:
        opt = {k: view for k in state.opt}
    return {"params": params, "opt": opt,
            "err": None if state.err is None else view}


def shard_state(cfg: ArchConfig, mesh, rules: AxisRules, state: "TrainState",
                *, serve: bool = False) -> "TrainState":
    """``state`` (whole tensors, the same on every rank) as DTensors on
    ``mesh``: the parameters placed by ``param_shardings``, the optimizer
    moments and the compression error as their parameters."""
    sh = state_shardings(cfg, mesh, rules, state, serve=serve)
    return TrainState(
        step=state.step, params=shard_tree(state.params, sh["params"]),
        opt=None if state.opt is None else shard_tree(state.opt, sh["opt"]),
        err=None if state.err is None else shard_tree(state.err, sh["err"]))


def value_and_grad(model: LM, params: Any,
                   batch: dict[str, Any]) -> tuple[tuple[Tensor, dict], Any]:
    """``((loss, metrics), grads)`` of ``model.loss_fn``; ``grads`` has
    ``params``' structure, f32 like the parameters, and a DTensor
    parameter's placements."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = model.loss_fn(tree_unflatten(params, xs), batch)
        grads = torch.autograd.grad(loss, xs)
    grads = [placed_as(g, x) for g, x in zip(grads, xs)]
    return ((full(loss.detach()),
             {k: full(v.detach()) for k, v in metrics.items()}),
            tree_unflatten(params, grads))


def make_train_step(
    model: LM,
    opt_cfg: OptConfig,
    *,
    grad_accum: int = 1,
    compression: CompressionConfig | None = None,
) -> Callable[[TrainState, dict[str, Any]], tuple[TrainState, dict]]:
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` leaves have leading dim ``global_batch``; with grad_accum > 1
    they are reshaped to (accum, global_batch / accum, ...) and run in
    turn.  The returned state holds the same tensors, updated in place;
    ``metrics`` are 0-d tensors ``{"loss", "ce", "aux"}``.
    """
    def split(x):
        x = torch.as_tensor(x)
        return x.reshape((grad_accum, x.shape[0] // grad_accum)
                         + tuple(x.shape[1:]))

    def train_step(state: TrainState, batch: dict[str, Any]):
        if grad_accum > 1:
            mbs = {k: split(v) for k, v in batch.items()}
            gsum = tree_map(zeros_f32, state.params)
            lsum = None
            for i in range(grad_accum):
                (loss, _), grads = value_and_grad(
                    model, state.params, {k: v[i] for k, v in mbs.items()})
                tree_map(lambda a, g: a.add_(g), gsum, grads)
                lsum = loss if lsum is None else lsum + loss
                del grads
            grads = tree_map(lambda g: g / grad_accum, gsum)
            del gsum
            loss = lsum / grad_accum
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        else:
            (loss, metrics), grads = value_and_grad(model, state.params,
                                                    batch)
        cfg = model.cfg
        grads = reference_view(cfg, grads)
        err = state.err
        if compression is not None:
            grads, err = compress_grads(grads, err, compression)
        _, opt = opt_update(reference_view(cfg, state.params), grads,
                            state.opt, opt_cfg, state.step)
        del grads
        new_state = TrainState(step=state.step + 1, params=state.params,
                               opt=opt, err=err)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return new_state, metrics

    return train_step
