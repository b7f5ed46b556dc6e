"""The port's device rule: CUDA unless the caller asks for the CPU.

There is no fallback: ``device=None`` on a machine without a card raises
instead of silently running the whole search on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
