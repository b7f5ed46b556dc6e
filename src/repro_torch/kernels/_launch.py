"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def cuda_f32(name: str, x: Tensor, shape: tuple[int, ...] | None = None,
             device: torch.device | None = None) -> Tensor:
    """Check that ``x`` is a contiguous float32 CUDA tensor (of ``shape``,
    on ``device``); the kernels take nothing else."""
    if not isinstance(x, Tensor) or not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if device is not None and x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    return x


def live_bytes(live, n: int, device: torch.device) -> Tensor | None:
    """A liveness mask as the kernels read it: one byte per entry."""
    if live is None:
        return None
    live = torch.as_tensor(live, device=device)
    return live.bool().expand(n).to(torch.uint8).contiguous()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
