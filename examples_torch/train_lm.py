"""Train a ~100M-parameter LM for a few hundred steps on synthetic data
(port of ``examples/train_lm.py``).

This drives the port's training path -- the layer stack under remat, K9
through its autograd Function (``attn_impl="kernel"``), chunked CE,
AdamW, checkpointing -- at a laptop-friendly size.  It prints the loss at
step 1 and every 10 steps, then one verdict line, ``loss fell: True``
when the last logged loss is below the first; it exits non-zero when a
loss is not finite or the loss did not fall.

Run: PYTHONPATH=src python examples_torch/train_lm.py --steps 200
(~100M params, on the card; pass --tiny for a quick smoke run and
--device cpu to run the plain versions on the CPU)
"""

import argparse
import dataclasses
import math
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ArchConfig
from repro_torch.data import TokenPipeline
from repro_torch.models import LM
from repro_torch.train import (OptConfig, init_state, make_train_step,
                               save_checkpoint)

CFG_100M = ArchConfig(
    name="repro-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab=32768,
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = CFG_100M
    if args.tiny:
        cfg = dataclasses.replace(cfg, n_layers=2, d_model=128, d_ff=256,
                                  vocab=1024, n_heads=4, n_kv_heads=2)
        args.steps = min(args.steps, 20)
        args.seq = 64

    model = LM(cfg, attn_impl="kernel")
    opt = OptConfig(lr=3e-4, warmup=20)
    state = init_state(model, torch.Generator(device=dev).manual_seed(0),
                       opt)
    n_params = sum(t.numel() for t in
                   torch.utils._pytree.tree_leaves(state.params))
    print(f"device: {dev}")
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")
    step = make_train_step(model, opt)
    pipe = TokenPipeline(cfg.vocab, args.batch, args.seq, seed=0)

    logged = []
    t0 = time.time()
    for i in range(args.steps):
        state, m = step(state, pipe.next_batch())
        loss = float(m["loss"])
        if not math.isfinite(loss):
            print(f"step {i + 1}: loss {loss} is not finite",
                  file=sys.stderr)
            return 1
        if (i + 1) % 10 == 0 or i == 0:
            logged.append(loss)
            print(f"step {i + 1:4d}  loss {loss:.4f}  "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, args.steps, state,
                        extra={"pipeline": pipe.state()})
        print(f"checkpoint written to {args.ckpt_dir}")
    fell = len(logged) > 1 and logged[-1] < logged[0]
    print(f"loss fell: {fell}")
    return 0 if fell else 1


if __name__ == "__main__":
    sys.exit(main())
