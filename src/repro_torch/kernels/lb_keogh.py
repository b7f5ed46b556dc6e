"""K8 wrapper: the LB_KEOGH matrix on the card (csrc/lb_keogh.cu).

Replaces ``src/repro/kernels/lb_keogh.py:lb_keogh_pallas``
(``_lb_keogh_kernel``).  Bound on this card: FP32 operations, ~6 per
(query, candidate, column): ~12.9 GFLOP at Q = 256, C = 16384, L = 512,
about 0.19 ms at 67 TFLOP/s, against ~70 MB of reads (~0.02 ms).  Design:
a block computes a 32 x 32 output tile and walks L in 32-column chunks as
a GEMM walks its k-loop, staging the query rows and both envelope rows of
the chunk in shared memory and accumulating in registers; the ragged
edges are masked in the kernel.  Its sum over L runs in another order
than the plain version's, so the two agree to rtol 1e-5.
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
