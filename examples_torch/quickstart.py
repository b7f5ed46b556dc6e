"""Quickstart: the paper's lower bounds on one pair of series (port of
``examples/quickstart.py``).

Run: PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import (
    dtw,
    envelope,
    lb_enhanced,
    lb_improved,
    lb_keogh,
    lb_kim,
    lb_new,
)
from repro_torch.data import random_pairs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    L = 128
    a_np, b_np = random_pairs(1, L, seed=42)
    a = torch.as_tensor(a_np[0], device=dev)
    b = torch.as_tensor(b_np[0], device=dev)
    w = int(0.3 * L)                           # Sakoe-Chiba window

    d = float(dtw(a, b, w))
    print(f"device: {dev}")
    print(f"DTW_w(A,B)         = {d:10.3f}   (squared cost, W={w})")
    print(f"{'bound':<18}{'value':>10}  tightness")
    admissible = True
    for name, val in [
        ("LB_KIM", float(lb_kim(a, b))),
        ("LB_KEOGH", float(lb_keogh(a, b, w))),
        ("LB_IMPROVED", float(lb_improved(a, b, w))),
        ("LB_NEW", float(lb_new(a, b, w))),
        ("LB_ENHANCED^1", float(lb_enhanced(a, b, w, 1))),
        ("LB_ENHANCED^4", float(lb_enhanced(a, b, w, 4))),
        ("LB_ENHANCED^8", float(lb_enhanced(a, b, w, 8))),
    ]:
        admissible &= val <= d * (1 + 1e-4)
        print(f"{name:<18}{val:>10.3f}  {val / d:8.3f}")

    u, lo = envelope(b, w)
    inside = float(((a >= lo) & (a <= u)).float().mean())
    print(f"\nquery points inside B's envelope: {inside:.0%} "
          f"(these contribute 0 to LB_KEOGH; the elastic bands still "
          f"extract cost from the first/last {4} positions)")
    print(f"every bound below DTW: {admissible}")
    if not admissible:
        raise SystemExit("a lower bound exceeded DTW!")


if __name__ == "__main__":
    main()
