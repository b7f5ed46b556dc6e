"""K7 wrapper: the tier-(-1) int8 sketch bound on the card
(csrc/sketch.cu).

Replaces ``src/repro/kernels/sketch.py:sketch_bound_pallas``
(``_sketch_kernel``).  Bound on this card: 7 FP32 instructions per
(query, candidate, segment), none fused (the arithmetic is held bit-equal
to the plain version), so the kernel is bound by the FP32 issue rate; the
``4 Q N`` output bytes weigh less at S = 16.  Design: one thread per
candidate column over a tile of 16 queries whose ``(16, S)`` means and
the S weights sit in shared memory; each thread reads its candidate's
int8 cells with 16-byte loads and converts them in registers.  A full
tile (16 queries, S a multiple of 16, aligned storage) runs with no
predicate in its unrolled loops, the chunk's weights in registers and
the queries read as float4; a ragged tile runs a predicated body.  Each
thread writes its column coalesced.  A second grid dimension covers any
Q (the JAX op's Q > 4096 fallback has no counterpart here).  The segments
are summed in the plain version's order with unfused products, so the
kernel is bit-equal to ``ref.sketch_bound_scaled``.  Raises for S > 256.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import cuda_f32, stream_ptr

Tensor = torch.Tensor


def sketch_bound_cuda(qs: Tensor, sk_lo: Tensor, sk_hi: Tensor,
                      wseg: Tensor) -> Tensor:
    """``(Q, S) f32 x (N, S) int8 -> (Q, N)`` in scaled units (the
    operands of ``ref.sketch_operands``) on the card."""
    if qs.dim() != 2 or sk_lo.dim() != 2:
        raise ValueError("qs, sk_lo: expected (Q, S) and (N, S)")
    Q, S = qs.shape
    N = sk_lo.shape[0]
    cuda_f32("qs", qs)
    cuda_f32("wseg", wseg, (S,), qs.device)
    for name, x in (("sk_lo", sk_lo), ("sk_hi", sk_hi)):
        if not x.is_cuda or x.device != qs.device:
            raise ValueError(f"{name}: expected a CUDA tensor on "
                             f"{qs.device}")
        if x.dtype != torch.int8 or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous int8")
        if tuple(x.shape) != (N, S):
            raise ValueError(f"{name}: expected shape {(N, S)}, got "
                             f"{tuple(x.shape)}")
    lib = _build.library()
    if lib.sketch_bound_smem_bytes(S) < 0:
        raise ValueError(f"sketch kernel: S={S} segments, it takes 1..256")
    out = torch.empty((Q, N), dtype=torch.float32, device=qs.device)
    if Q == 0 or N == 0:
        return out
    _build.check(lib.sketch_bound_launch(
        qs.data_ptr(), sk_lo.data_ptr(), sk_hi.data_ptr(), wseg.data_ptr(),
        out.data_ptr(), Q, N, S, stream_ptr(qs.device)), "sketch_bound")
    _build.COUNTS["sketch_bound"] += 1
    return out
