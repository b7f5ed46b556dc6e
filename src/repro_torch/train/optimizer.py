"""Optimizers: AdamW and (factored) Adafactor on trees of tensors (port of
``repro.train.optimizer``).

AdamW is the default.  Adafactor (factored second moment, no first moment)
is selected for the very largest archs, where Adam's 8 bytes of state per
parameter do not fit.

The reference's arithmetic, in its order: the learning rate, the bias
corrections ``c1``, ``c2`` and Adafactor's ``beta2`` are f32 scalars
(computed here with numpy's f32), AdamW's update is ``(m / c1) /
(sqrt(v / c2) + eps)`` and weight decay applies only to leaves with
``ndim >= 2`` (``torch.optim.AdamW`` decays every parameter and orders
its update otherwise, so it is not used).

Parameters may be ``Stacked`` leaves (``repro_torch.tree``): the
reference's layout of the port's per-layer tensors, whose ``ndim`` counts
the stacking axis, as the reference's scanned leaves do.  The optimizer
state is in that layout too, each leaf one tensor of the reference's
shape.  ``opt_update`` updates the parameters and the state in place (a
second copy of a full-size model's f32 parameters and moments would not
fit beside the first on one card) and returns them; the gradients are
only read.

Sharded parameters (DTensors, ``distributed.sharding``) keep their
placements: their gradients and moments are placed as they are
(Adafactor's row and column moments as the dimensions they keep), and
every reduction the reference makes over a whole leaf or tree (the
global-norm clip, Adafactor's means and update RMS) reduces across the
shards.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.distributed.sharding import full, is_dtensor, placed_as
from repro_torch.tree import Stacked, tensors, tree_map, zeros_f32

Tensor = torch.Tensor
_f32 = np.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"              # "adamw" | "adafactor"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup: int = 100


def _lr_at(cfg: OptConfig, step: int) -> float:
    """``lr * min(1, (step + 1) / warmup)`` in f32."""
    warm = min(_f32(1.0), _f32(step + 1) / _f32(max(cfg.warmup, 1)))
    return float(_f32(cfg.lr) * warm)


def global_norm(tree: Any) -> Tensor:
    """The L2 norm of every tensor of the tree, in f32."""
    sq = [full(torch.sum(torch.square(t.float()))) for t in tensors(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(tree: Any, max_norm: float) -> tuple[Any, Tensor]:
    """``(tree * min(1, max_norm / norm), norm)``; ``tree`` is not
    modified."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: _scaled(g, scale), tree), norm


def _clip_scale(norm: Tensor, max_norm: float) -> Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _scaled(g, scale: Tensor | None):
    if isinstance(g, Stacked):
        return Stacked([_scaled(m, scale) for m in g.members])
    return g if scale is None else g * scale


def _pairs(p, *rest):
    """``(tensor, matching tensors...)`` of a leaf: a ``Stacked`` leaf's
    members with row ``r`` of its state tensors (views)."""
    if isinstance(p, Stacked):
        for x in rest:
            if is_dtensor(x) and any(getattr(q, "dim", None) == 0
                                     for q in x.placements):
                raise ValueError("a stacked state tensor sharded on its "
                                 "layer axis: its rows are not views")
        return [(m, *(x.members[r] if isinstance(x, Stacked) else x[r]
                      for x in rest)) for r, m in enumerate(p.members)]
    return [(p, *rest)]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params: Any) -> dict[str, Any]:
    return {"mu": tree_map(zeros_f32, params),
            "nu": tree_map(zeros_f32, params)}


def adamw_update(params: Any, grads: Any, state: dict[str, Any],
                 cfg: OptConfig, step: int,
                 scale: Tensor | None = None) -> tuple[Any, dict[str, Any]]:
    """One AdamW step in place; ``scale`` multiplies the gradients first
    (the global-norm clip)."""
    lr = _lr_at(cfg, step)
    t = _f32(step + 1)
    c1 = float(_f32(1.0) - np.power(_f32(cfg.b1), t))
    c2 = float(_f32(1.0) - np.power(_f32(cfg.b2), t))

    def upd(p, g, m, v):
        decay = p.dim() >= 2
        for pt, gt, mt, vt in _pairs(p, g, m, v):
            gt = gt.float()
            if scale is not None:
                gt = gt * scale
            # the reference's expressions, each op rounded as there; the
            # in-place forms only save memory
            mt.mul_(cfg.b1).add_((1 - cfg.b1) * gt)
            g2 = (1 - cfg.b2) * gt
            vt.mul_(cfg.b2).add_(g2.mul_(gt))
            del g2, gt
            u = (vt / c2).sqrt_().add_(cfg.eps)
            u = (mt / c1).div_(u)
            if decay:
                u.add_(cfg.weight_decay * pt.float())
            pt.sub_(u.mul_(lr))          # in f32, rounded to p's dtype

    tree_map(upd, params, grads, state["mu"], state["nu"])
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, momentum-free)
# ---------------------------------------------------------------------------

def adafactor_init(params: Any) -> dict[str, Any]:
    def stats(p):
        n = p.dim()
        if n >= 2:
            return {"vr": zeros_f32(p, p.shape[:-1], range(n - 1)),
                    "vc": zeros_f32(p, p.shape[:-2] + p.shape[-1:],
                                    (*range(n - 2), n - 1))}
        return {"v": zeros_f32(p)}

    return {"stats": tree_map(stats, params)}


def adafactor_update(params: Any, grads: Any, state: dict[str, Any],
                     cfg: OptConfig, step: int,
                     scale: Tensor | None = None) -> tuple[Any, dict[str, Any]]:
    """One Adafactor step in place.  A ``Stacked`` leaf runs as one
    stacked tensor (its moments factor over the stacking axis when its
    members are 1-D, and its update RMS spans every layer)."""
    lr = _lr_at(cfg, step)
    beta2 = float(_f32(1.0) - np.power(_f32(step + 1.0), _f32(-0.8)))
    eps = 1e-30

    def upd(p, g, st):
        stacked = isinstance(p, Stacked)
        pt = p.stack() if stacked else p
        gt = (g.stack() if stacked else g).float()
        if scale is not None:
            gt = gt * scale
        g2 = gt * gt + eps
        if pt.dim() >= 2:
            vr = beta2 * st["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * st["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
            rfac = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                    min=eps)
            v = rfac[..., None] * vc[..., None, :]
            st["vr"].copy_(placed_as(vr, st["vr"]))
            st["vc"].copy_(placed_as(vc, st["vc"]))
        else:
            v = beta2 * st["v"] + (1 - beta2) * g2
            st["v"].copy_(placed_as(v, st["v"]))
        u = gt / torch.sqrt(torch.clamp(v, min=eps))
        # update clipping (RMS <= 1) per the Adafactor paper
        rms = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp(rms, min=1.0)
        if pt.dim() >= 2:
            u = u + cfg.weight_decay * pt.float()
        newp = placed_as((pt.float() - lr * u).to(pt.dtype), pt)
        if stacked:
            p.write(newp)
        else:
            p.copy_(newp)

    tree_map(upd, params, grads, state["stats"])
    return params, state


# ---------------------------------------------------------------------------

def opt_init(params: Any, cfg: OptConfig) -> dict[str, Any]:
    if cfg.name == "adamw":
        return adamw_init(params)
    if cfg.name == "adafactor":
        return adafactor_init(params)
    raise ValueError(cfg.name)


@torch.no_grad()
def opt_update(params: Any, grads: Any, state: dict[str, Any],
               cfg: OptConfig, step: int) -> tuple[Any, dict[str, Any]]:
    """Clip by the global norm (``cfg.grad_clip``), then one step of
    ``cfg.name``, in place; returns ``(params, state)``."""
    if cfg.name not in ("adamw", "adafactor"):
        raise ValueError(cfg.name)
    step = int(step)
    scale = None
    if cfg.grad_clip:
        scale = _clip_scale(global_norm(grads), cfg.grad_clip)
    update = adamw_update if cfg.name == "adamw" else adafactor_update
    return update(params, grads, state, cfg, step, scale)

