"""Device meshes over a ``torch.distributed`` world (port of
``repro.launch.mesh``).

``make_host_mesh`` names the axes of the world's ranks, one rank a
device, as ``jax.make_mesh`` names devices.  The world comes first: the
caller runs ``torch.distributed.init_process_group`` with its address,
world size and rank (gloo for a ``"cpu"`` mesh, NCCL for a ``"cuda"``
one), since nothing tells a process of a cluster.

``device_type="meta"`` is the dry-run's mesh (``launch.dryrun``): a world
of the ``fake`` backend (``torch.testing._internal.distributed.fake_pg``),
256 or 512 ranks in one process, whose tensors live on the meta device.
Its collectives move nothing, so it serves no real tensor: a ``"cpu"`` or
``"cuda"`` mesh refuses a fake world, and a ``"meta"`` mesh a real one.
The ``DeviceMesh`` itself is of type ``"cuda"``, so DTensor picks its
redistributions as on the card (``all_to_all``, where a CPU mesh falls
back to a gather) and needs no card to do so.

``make_production_mesh`` is the deployment mesh of the sharding rules
(``distributed.sharding``): a (16, 16) ``("data", "model")`` pod of 256
ranks, or two pods (2, 16, 16) with a leading pure-DP ``pod`` axis, 512
ranks.  A smaller world raises and names the count, as the reference
does when it has too few devices; the rules themselves can be checked
without the ranks on a mesh stub (``tests/test_torch_sharding.py``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# the backend each mesh device type runs its collectives on; there is no
# fallback from one to the other
BACKENDS = {"cpu": "gloo", "cuda": "nccl", "meta": "fake"}


def make_host_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
                   device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the whole world,
    ranks in row-major order (``axes[0]`` major).

    ``device_type="cuda"`` (the default) needs a card and a world whose
    default group runs NCCL, and puts rank ``r`` on card ``r % count``;
    ``"cpu"`` needs gloo, ``"meta"`` the fake backend.  Raises when the
    world is not initialised, its size is not ``prod(shape)``, or its
    backend does not serve ``device_type``.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if device_type not in BACKENDS:
        raise ValueError(f"device_type {device_type!r}: use 'cuda', 'cpu' "
                         "or 'meta'")
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    if device_type == "cuda":
        resolve_device("cuda")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh needs a torch.distributed world: call "
            "init_process_group first (backend "
            f"{BACKENDS[device_type]!r} for a {device_type!r} mesh)")
    backend = str(dist.get_backend())
    if BACKENDS[device_type] not in backend:
        raise RuntimeError(
            f"a {device_type!r} mesh runs its collectives on "
            f"{BACKENDS[device_type]}; the world's backend is {backend}")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks, the world has "
                           f"{dist.get_world_size()}")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh("cuda" if device_type == "meta" else device_type,
                            shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The target deployment mesh: one 16 x 16 pod (256 ranks), or two
    pods (512 ranks) with a leading pure-DP ``pod`` axis, over a world of
    exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"need {n} ranks for the production mesh {shape}, the world has "
            f"{have} (init_process_group with world_size={n} first)")
    return make_host_mesh(shape, axes, device_type=device_type)
