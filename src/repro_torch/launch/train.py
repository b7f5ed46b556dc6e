"""Production training launcher (port of ``repro.launch.train``).

Single process (reduced preset, on the CPU):

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --preset reduced --steps 50 --ckpt-dir /tmp/ckpt --device cpu

Several ranks, one process a rank (``torchrun --nproc-per-node N -m
repro_torch.launch.train ...``, or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``): the mesh is planned
from the world's size (``plan_mesh``, elastic), the state is sharded by
the sharding rules, the latest checkpoint is restored onto the current
mesh (whatever mesh saved it) with the data pipeline's cursor, and a
heartbeat file is refreshed every step for the straggler monitor.

``main(argv)`` takes the flags as a list and returns the run's losses and
step walls, so a script can drive it.  The model runs K9 and K10 (their
plain versions on the CPU) in the compute dtype bf16, as the reference's
launcher does.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import ARCHS, get_arch, reduced
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed.elastic import Heartbeat, plan_mesh
from repro_torch.distributed.sharding import AxisRules
from repro_torch.launch.mesh import BACKENDS, make_host_mesh
from repro_torch.models import LM
from repro_torch.train import (OptConfig, TrainState, init_state,
                               latest_step, make_train_step,
                               restore_checkpoint, save_checkpoint)
from repro_torch.train.trainer import shard_state, state_shardings


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2.5-3b", choices=sorted(ARCHS))
    ap.add_argument("--preset", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--heartbeat", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _world(dev: torch.device) -> int:
    """The world's size, joining it from the launcher's environment when
    ``WORLD_SIZE`` says there is one and no group exists yet."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(BACKENDS[dev.type], init_method="env://")
        return dist.get_world_size()
    return 1


def main(argv: list[str] | None = None) -> dict:
    args = _parser().parse_args(argv)
    cfg = get_arch(args.arch)
    if args.preset == "reduced":
        cfg = reduced(cfg)
    dev = resolve_device(args.device)

    n_ranks = _world(dev)
    mesh = None
    rules = AxisRules()
    rank = 0
    if n_ranks > 1:
        import torch.distributed as dist

        rank = dist.get_rank()
        plan = plan_mesh(n_ranks)
        mesh = make_host_mesh(plan.shape, plan.axes, device_type=dev.type)
        rules = AxisRules.for_mesh(mesh)
        if rank == 0:
            print(f"mesh: {plan.shape} {plan.axes}")

    model = LM(cfg, mesh=mesh, dp_axes=rules.dp, attn_impl="kernel",
               ssm_impl="kernel")
    opt_cfg = OptConfig(lr=args.lr, warmup=10)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_state(model, gen, opt_cfg, device=dev)
    if mesh is not None:
        state = shard_state(cfg, mesh, rules, state)

    pipe = TokenPipeline(cfg.vocab, args.batch, args.seq, seed=0)
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        shardings = None
        if mesh is not None:
            sh = state_shardings(cfg, mesh, rules, state)
            shardings = TrainState(step=None, params=sh["params"],
                                   opt=sh["opt"], err=sh["err"])
        state, extra = restore_checkpoint(args.ckpt_dir, state, device=dev,
                                          shardings=shardings)
        pipe.restore(extra["pipeline"])
        start = int(state.step)
        if rank == 0:
            print(f"restored step {start} from {args.ckpt_dir}")

    hb = Heartbeat(args.heartbeat, host_id=rank) if args.heartbeat else None
    step_fn = make_train_step(model, opt_cfg, grad_accum=args.grad_accum)

    losses, walls = [], []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        t_step = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe.next_batch().items()}
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])       # waits for the step
        walls.append(time.perf_counter() - t_step)
        losses.append(loss)
        if hb:
            hb.beat(i)
        if rank == 0 and ((i + 1) % args.log_every == 0 or i == start):
            dt = time.perf_counter() - t0
            print(f"step {i + 1:5d}  loss {loss:.4f}  "
                  f"({dt / max(i + 1 - start, 1):.2f}s/step)", flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, i + 1, state,
                            extra={"pipeline": pipe.state()})
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, state,
                        extra={"pipeline": pipe.state()})
    if rank == 0:
        print("done.")
    return {"start": start, "losses": losses, "step_s": walls}


if __name__ == "__main__":
    main()
