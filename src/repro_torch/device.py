"""The port's device rule: CUDA unless the caller asks for the CPU.

There is no fallback: ``device=None`` on a machine without a card raises
instead of silently running the whole search on the CPU.  ``"meta"``
(shapes and dtypes, no data: the dry-run's device, ``launch.dryrun``) is
taken only when the caller names it; no kernel op runs there.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request without a card raises;
    ``"cpu"`` and ``"meta"`` only when named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise RuntimeError(f"unsupported device {dev}: use 'cuda', 'cpu' "
                           "or 'meta'")
    return dev
