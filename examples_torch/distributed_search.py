"""Distributed NN-DTW search over a (data, model) mesh, on the PyTorch/CUDA
port (port of ``examples/distributed_search.py``).

The candidate store is sharded over 'data', the queries over 'model'; each
rank runs the local tier pipeline with the *global survivor budget* (the
default: per-shard refine limits in proportion to all-gathered tier-0/1
survivor mass, search/distributed.py), and the per-query top-k merges with
one all_gather.  One process a rank: on the CPU (``--device cpu``) the
script spawns a gloo world of 8 ranks in a (4, 2) mesh, as the JAX example
emulates 8 devices; on the card (the default) it runs one NCCL rank, a
(1, 1) mesh.

Run: PYTHONPATH=src python examples_torch/distributed_search.py
     [--device cpu]
"""

import argparse
import datetime
import os
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.data import make_dataset
from repro_torch.launch.mesh import BACKENDS, make_host_mesh
from repro_torch.search import (
    CascadeConfig,
    EngineConfig,
    brute_force,
    build_index,
    make_distributed_search,
    shard_index,
)


# the mesh on each device type: 8 gloo ranks on the CPU, one NCCL rank on
# the card
MESH = {"cpu": (4, 2), "cuda": (1, 1)}


def _rank(rank: int, args, init: str) -> None:
    shape = MESH[args.device]
    world = shape[0] * shape[1]
    if args.device == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group(BACKENDS[args.device], init_method=init,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        exact = _search(rank, args, shape)
        # leave together: a rank tearing gloo down while another still
        # talks to it aborts
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if not exact:           # every rank holds the same verdict
        raise SystemExit("the distributed search changed the NN result!")


def _search(rank: int, args, shape) -> bool:
    mesh = make_host_mesh(shape, ("data", "model"), device_type=args.device)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if args.device == "cuda" else torch.device("cpu"))
    if rank == 0:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
              f"{mesh.size()} ranks ({BACKENDS[args.device]}, {dev})")

    ds = make_dataset(n_classes=4, n_train_per_class=args.per_class,
                      n_test_per_class=args.n_test, length=args.length,
                      seed=13)
    w = int(0.2 * ds.length)
    k = 3
    idx = build_index(ds.x_train, w, ds.y_train, device=dev)
    cfg = EngineConfig(cascade=CascadeConfig(w=w, v=4), verify_chunk=16, k=k)
    sidx = shard_index(mesh, idx, ("data",))
    step = make_distributed_search(mesh, cfg, data_axes=("data",),
                                   query_axis="model")

    q = torch.as_tensor(ds.x_test, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    d, i, n_dtw = step(sidx.series, sidx.labels, sidx.upper, sidx.lower,
                       sidx.kim, sidx.kim_ok, q)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    # this rank's query block against single-device brute force on the
    # whole store, then every block's verdict and results on rank 0
    b = q.shape[0] // shape[1]
    m = mesh.get_coordinate()[1]
    bd, bi = brute_force(idx, q[m * b:(m + 1) * b], w, k=k)
    ok = torch.tensor([int(torch.equal(d, bd) and torch.equal(i, bi))],
                      device=dev)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    exact = bool(ok.item())
    model = mesh.get_group("model")
    blocks = [torch.empty_like(x) for x in (i, n_dtw)
              for _ in range(shape[1])]
    dist.all_gather(blocks[:shape[1]], i, group=model)
    dist.all_gather(blocks[shape[1]:], n_dtw, group=model)
    if rank != 0:
        return exact
    ids = torch.cat(blocks[:shape[1]]).cpu().numpy()
    n_all = torch.cat(blocks[shape[1]:]).cpu().numpy()
    print(f"{k}-NN over {idx.n} candidates x {q.shape[0]} queries: "
          f"{dt:.2f}s")
    print(f"exact vs single-device brute force: {exact}")
    print(f"mean DTW verified per query (all shards): "
          f"{float(np.mean(n_all)):.1f} / {idx.n}")
    votes = idx.labels.cpu().numpy()[ids]
    pred = np.apply_along_axis(lambda r: np.bincount(r).argmax(), 1, votes)
    print(f"accuracy: {float(np.mean(pred == ds.y_test)):.1%}")
    return exact


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="'cuda' (the default: NCCL) or 'cpu' (gloo)")
    ap.add_argument("--per-class", type=int, default=64)
    ap.add_argument("--n-test", type=int, default=8)
    ap.add_argument("--length", type=int, default=128)
    args = ap.parse_args()
    shape = MESH[args.device]
    world = shape[0] * shape[1]
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu for a gloo world "
                           "on the CPU")
    if world == 1:
        _rank(0, args, f"tcp://localhost:{_free_port()}")
        return
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(args, f"file://{os.path.join(tmp, 'rdv')}"),
                           nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main()
