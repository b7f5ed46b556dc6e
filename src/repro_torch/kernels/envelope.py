"""K1 wrapper: Sakoe-Chiba envelopes on the card (csrc/envelope.cu).

Replaces ``src/repro/kernels/envelope.py:envelope_pallas``
(``_envelope_kernel``).  Bound on this card: memory, 12 bytes per element
(read the series, write both envelopes).  Design: one block per (row,
1024-output tile) with the tile and its +-w halo in shared memory, so each
element is read from device memory once; the windowed max/min runs from
shared memory, exact and bit-equal to ``ref.envelope_ref``.  Raises when
the window's shared-memory tile exceeds what a block may hold.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import cuda_f32, stream_ptr

Tensor = torch.Tensor


def envelope_cuda(b: Tensor, w: int) -> tuple[Tensor, Tensor]:
    """``(N, L) -> ((N, L) upper, (N, L) lower)`` on the card."""
    if b.dim() != 2:
        raise ValueError(f"b: expected (N, L), got {tuple(b.shape)}")
    cuda_f32("b", b)
    n, L = b.shape
    w = min(int(w), L)
    if w < 0:
        raise ValueError(f"w must be >= 0, got {w}")
    lib = _build.library()
    if lib.envelope_smem_bytes(L, w) < 0:
        raise ValueError(f"envelope kernel: L={L}, w={w} exceeds a "
                         "block's shared memory")
    u = torch.empty_like(b)
    lo = torch.empty_like(b)
    if n == 0 or L == 0:
        return u, lo
    _build.check(lib.envelope_launch(b.data_ptr(), u.data_ptr(),
                                     lo.data_ptr(), n, L, w,
                                     stream_ptr(b.device)), "envelope")
    _build.COUNTS["envelope"] += 1
    return u, lo
