"""Fault-tolerant checkpointing: atomic, portable (port of
``repro.train.checkpoint``, the same format).

Format: one directory per step containing
  * ``manifest.json`` -- step, the flattened tree's leaf names (the
    port's tree paths, ``repro_torch.tree.named_leaves``) with per-leaf
    dtype and shape, and ``extra`` (e.g. the data-pipeline cursor);
  * ``arrays.npz`` -- the leaves, copied to the host (bfloat16 as
    float32, restored to the like-tree's dtype).

Guarantees:
  * **atomicity**: written to ``<dir>.tmp`` then ``os.rename``d -- a job
    killed mid-write can never leave a half checkpoint that restore picks;
  * **placement on restore**: every tensor goes to the device
    ``restore_checkpoint`` is given (default the card), whatever device
    saved it;
  * **elasticity**: a sharded state (DTensors) is saved whole -- each
    leaf gathered, as the reference's ``np.asarray`` gathers, written by
    rank 0 while the others wait -- and ``restore_checkpoint(...,
    shardings=)`` places each leaf on the *current* mesh, so the saving
    and restoring meshes may differ (elastic scale-up/down, evicted
    hosts);
  * **retention**: the ``keep`` newest checkpoints are retained,
    best-effort GC.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import distribute, full, is_dtensor
from repro_torch.tree import named_leaves, tree_unflatten


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = full(leaf.detach())
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def save_checkpoint(directory: str, step: int, state: Any, *,
                    extra: dict[str, Any] | None = None,
                    keep: int = 3) -> str:
    """Atomically write ``state`` (any tree of tensors and numbers) for
    ``step``.  In a ``torch.distributed`` world every rank calls it (a
    DTensor leaf is gathered by all); rank 0 writes."""
    final = os.path.join(directory, f"step_{step:08d}")
    named = named_leaves(state)
    arrays = {f"a{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(named)}
    if _rank() != 0:
        _barrier()
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "names": [n for n, _ in named],
        "shapes": [list(np.shape(a)) for a in arrays.values()],
        "dtypes": [_dtype_name(leaf) for _, leaf in named],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic publish
    _gc(directory, keep)
    _barrier()
    return final


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in ckpts[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, state_like: Any, *,
                       step: int | None = None, device=None,
                       shardings: Any | None = None
                       ) -> tuple[Any, dict[str, Any]]:
    """Restore into the structure of ``state_like`` (its leaf names must
    be the saved ones): tensors in the like-tree's dtypes on ``device``
    (default the card), numbers as Python numbers.  ``shardings`` (a tree
    of ``distributed.sharding.NamedSharding`` matching ``state_like``'s
    tensors, any of them None) places each leaf on its mesh -- the
    elastic-restart path; a DTensor leaf of ``state_like`` without one
    keeps its own placements.  Returns (state, extra)."""
    dev = resolve_device(device)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    named = named_leaves(state_like)
    if [n for n, _ in named] != manifest["names"]:
        raise ValueError(f"{path}: tree structure mismatch")
    placed = dict(named_leaves(shardings)) if shardings is not None else {}
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (name, like) in enumerate(named):
            arr = data[f"a{i}"]
            if isinstance(like, torch.Tensor):
                t = torch.from_numpy(np.array(arr)).to(device=dev,
                                                       dtype=like.dtype)
                sh = placed.get(name)
                if sh is not None:
                    t = distribute(t, sh)
                elif is_dtensor(like):
                    from torch.distributed.tensor import distribute_tensor

                    t = distribute_tensor(t, like.device_mesh,
                                          like.placements,
                                          src_data_rank=None)
                leaves.append(t)
            else:
                leaves.append(type(like)(arr.item()) if arr.ndim == 0
                              else arr)
    return tree_unflatten(state_like, leaves), manifest["extra"]
