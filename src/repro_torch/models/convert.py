"""Carry the JAX package's parameters and caches into the port.

The JAX ``LM`` stacks the layers of each position of its periodic layout
along a leading ``n_repeat`` axis (``params["scan"][pos]``) after the
``first_dense`` prelude layers; the port keeps one dict per layer.  Layer
``first_dense + r * len(period) + pos`` is ``scan[pos]`` at index ``r``.
The trees arrive as numpy (``jax.tree.map(np.asarray, tree)``), so this
module imports nothing of JAX; bfloat16 arrays come through float32.
``train_state_from_numpy`` carries a whole JAX ``TrainState`` across, so
one step can run in JAX and the next in the port.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device


def _to_torch(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _slice(tree: Any, r: int) -> Any:
    if isinstance(tree, dict):
        return {k: _slice(v, r) for k, v in tree.items()}
    return tree[r]


def unstack_layers(cfg: ArchConfig, prelude: list, scan: list) -> list:
    """Per-layer trees in layer order from the JAX prelude + scanned
    stacks."""
    _, period, n_repeat = cfg.layout()
    layers = list(prelude)
    for r in range(n_repeat):
        layers.extend(_slice(scan[pos], r) for pos in range(len(period)))
    return layers


def lm_params_from_numpy(cfg: ArchConfig, tree: dict[str, Any],
                         device=None) -> dict[str, Any]:
    """The JAX ``LM.init`` tree (as numpy) -> the port's parameter dict on
    ``device`` (default CUDA)."""
    out = {k: tree[k] for k in ("final_norm", "embed", "in_norm", "head")
           if k in tree}
    out["layers"] = unstack_layers(cfg, tree["prelude"], tree["scan"])
    return _to_torch(out, resolve_device(device))


def lm_caches_from_numpy(cfg: ArchConfig, caches: dict[str, Any],
                         device=None) -> list:
    """The JAX ``LM`` caches (as numpy) -> the port's per-layer list."""
    return _to_torch(unstack_layers(cfg, caches["prelude"], caches["scan"]),
                     resolve_device(device))


def train_state_from_numpy(cfg: ArchConfig, state: Any, device=None):
    """A JAX ``TrainState`` (as numpy: ``jax.tree.map(np.asarray,
    state)``) -> the port's ``TrainState`` on ``device`` (default CUDA):
    the parameters unstacked into per-layer dicts, the optimizer state
    (AdamW's ``mu`` / ``nu``, Adafactor's ``vr`` / ``vc`` / ``v``) and the
    compression error kept in the reference's layout, which is the port's
    layout for them (``train.trainer.reference_view``), and the step."""
    from repro_torch.train.trainer import TrainState

    dev = resolve_device(device)
    return TrainState(
        step=int(np.asarray(state.step)),
        params=lm_params_from_numpy(cfg, state.params, dev),
        opt=_to_torch(state.opt, dev),
        err=None if state.err is None else _to_torch(state.err, dev))
