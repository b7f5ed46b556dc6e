"""K1 wrapper: Sakoe-Chiba envelopes on the card (csrc/envelope.cu).

Replaces ``src/repro/kernels/envelope.py:envelope_pallas``
(``_envelope_kernel``).  Bound on this card: memory, 12 bytes per element
(read the series, write both envelopes).  Design: van Herk / Gil-Werman
segment scans, O(L) per row for any window, in a persistent grid of
blocks that each keep one row's prefix and suffix extrema in a
device-memory scratch of ``(grid, 4, L)`` floats allocated here; nothing
in shared memory grows with ``w``, so every ``(L, w)`` runs.  Exact and
bit-equal to ``ref.envelope_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import cuda_f32, stream_ptr

Tensor = torch.Tensor

# the persistent grid: blocks per SM, and the scratch cap that bounds it
# for long rows
_BLOCKS_PER_SM = 8
_MAX_SCRATCH_BYTES = 256 << 20


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
    u = torch.empty_like(b)
    lo = torch.empty_like(b)
    if n == 0 or L == 0:
        return u, lo
    sms = torch.cuda.get_device_properties(b.device).multi_processor_count
    # at most one block per row, fewer where the (grid, 4, L) f32 scratch
    # would pass the cap
    grid = max(1, min(n, _BLOCKS_PER_SM * sms,
                      _MAX_SCRATCH_BYTES // (16 * L)))
    # freed at return: the caching allocator gives it out again only to
    # work queued after this launch on the same stream
    scratch = torch.empty((grid, 4, L), dtype=b.dtype, device=b.device)
    _build.check(lib.envelope_launch(b.data_ptr(), u.data_ptr(),
                                     lo.data_ptr(), scratch.data_ptr(), grid,
                                     n, L, w, stream_ptr(b.device)),
                 "envelope")
    _build.COUNTS["envelope"] += 1
    return u, lo
