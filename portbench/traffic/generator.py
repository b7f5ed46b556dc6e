"""The one traffic generator: query batches from a mix's parameters.

A query is a new instance of one of the store's classes, drawn as the
store was (a classification set's test split).  A mix
(``traffic/<name>.json``) holds:

  batch:  queries per ``nn_search`` call;
  w:      the Sakoe-Chiba window the index is built for and searched at.

Batches run back to back (a closed loop of one client).  Batch ``b`` of
a run is drawn from its own stream of the run's seed, so it is the same
whatever the window's length; the warm-up batches have a stream apart.
"""

from __future__ import annotations

import torch

from portbench import datagen


def validate(mix: dict, cfg: dict) -> None:
    if not 1 <= int(mix["batch"]):
        raise ValueError("traffic batch must be >= 1")
    if not 0 <= int(mix["w"]) <= cfg["length"]:
        raise ValueError(f"traffic w {mix['w']} outside [0, L]")


def batch(mix: dict, cfg: dict, store: dict, seed: int, stream: str,
          b: int) -> torch.Tensor:
    """``(batch, L)`` float32 queries of batch ``b`` of ``stream``
    (``"window"`` or ``"warmup"``), on the store's device."""
    dev = store["series"].device
    g = datagen.generator(seed, stream, b, device=dev)
    labels = torch.randint(0, cfg["n_classes"], (int(mix["batch"]),),
                           generator=g, device=dev)
    return datagen.instances(store["protos"], labels, g, warp=cfg["warp"],
                             noise=cfg["noise"], amp=cfg["amp_jitter"])
