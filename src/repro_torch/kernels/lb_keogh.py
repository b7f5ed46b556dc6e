"""K8 wrapper: the LB_KEOGH matrix on the card (csrc/lb_keogh.cu).

Replaces ``src/repro/kernels/lb_keogh.py:lb_keogh_pallas``
(``_lb_keogh_kernel``).  Bound on this card: FP32 operations, 5 per
(query, candidate, column), the least a term needs: ~10.7 GFLOP at
Q = 256, C = 16384, L = 512, about 0.16 ms at 67 TFLOP/s, against ~70 MB
of reads (~0.02 ms); the attainable floor is the issue rate, 4
instructions a term at 128 lanes an SM a clock, ~0.26 ms there.  Design:
the clamp form ``d = q - min(max(q, lo), u)``, ``acc = fma(d, d, acc)``,
equal term by term to the reference's where ``lo <= u`` (a chunk holding
an envelope element with ``lo > u`` or a NaN runs the reference's
arithmetic), over 128 x 64 output tiles with 8 x 4 outputs a thread, L
walked in 32-column chunks copied in by ``cp.async`` while the last one is
computed; the ragged edges are masked in the kernel.  Its sum over L runs
in another order than the plain version's, so the two agree to rtol
1e-5.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import cuda_f32, stream_ptr

Tensor = torch.Tensor


def lb_keogh_cuda(q: Tensor, u: Tensor, lo: Tensor) -> Tensor:
    """``(Q, L) x (C, L)`` envelopes ``-> (Q, C)`` on the card."""
    if q.dim() != 2 or u.dim() != 2:
        raise ValueError("q, u: expected (Q, L) and (C, L)")
    Q, L = q.shape
    C = u.shape[0]
    cuda_f32("q", q)
    cuda_f32("u", u, (C, L), q.device)
    cuda_f32("lo", lo, (C, L), q.device)
    out = torch.empty((Q, C), dtype=torch.float32, device=q.device)
    if Q == 0 or C == 0:
        return out
    lib = _build.library()
    _build.check(lib.lb_keogh_launch(q.data_ptr(), u.data_ptr(),
                                     lo.data_ptr(), out.data_ptr(), Q, C, L,
                                     stream_ptr(q.device)), "lb_keogh")
    _build.COUNTS["lb_keogh"] += 1
    return out
