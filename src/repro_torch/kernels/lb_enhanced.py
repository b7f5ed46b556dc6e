"""K2 wrapper: cross-block LB_ENHANCED^V on the card
(csrc/lb_enhanced.cu).

Replaces ``src/repro/kernels/lb_enhanced.py:lb_enhanced_pallas``
(``_lb_enhanced_kernel``, ``_lb_enhanced_kernel_live``).  The cascade's
``bands`` tier runs it with ``bands_only=True``, once per tier call over
the whole store: 4 bytes written and ~71 FP32 operations per pair at
V = 4.  That form stages the first and last ``nb`` columns of a block's
128 candidates and 32 queries in shared memory, keeps each candidate's
band values in registers and writes its column coalesced; it is bit-equal
to ``ref.lb_enhanced_ref``.  The full form (the ``enhanced_dense`` tier of
``CascadeConfig(staged=False)``) runs K8's clamp form over the bridge
``[nb, L - nb)`` (the body ``kg_tile`` of ``csrc/lb_keogh.cuh``: 128 x 64
output tiles, 8 x 4 sums a thread, ``cp.async`` chunks of 32 columns, a
partial a chunk), then adds the bands, summed as the bands form sums them,
in one unfused add; it agrees with ``ref.lb_enhanced_ref`` to rtol 1e-5,
atol 1e-6 (its bridge sum runs in another order), and at V = 0 it is K8's
sum bit for bit.  ``live`` (``(C,)``) turns dead candidates into ``-inf``
columns; an all-dead tile of candidates (128 in the bands form, 64 in the
full form) writes them and skips its copies and compute.  Each form has
its own launch count: ``lb_enhanced`` (bands) and ``lb_enhanced_full``.
"""

from __future__ import annotations

import torch

from repro_torch.core.lower_bounds import _n_bands
from repro_torch.kernels import _build
from repro_torch.kernels._launch import cuda_f32, live_bytes, stream_ptr

Tensor = torch.Tensor


def lb_enhanced_cuda(q: Tensor, c: Tensor, u: Tensor, lo: Tensor, w: int,
                     v: int, *, live: Tensor | None = None,
                     bands_only: bool = False) -> Tensor:
    """``(Q, L) x (C, L) -> (Q, C)`` on the card."""
    if q.dim() != 2 or c.dim() != 2:
        raise ValueError("q, c: expected (Q, L) and (C, L)")
    Q, L = q.shape
    C = c.shape[0]
    cuda_f32("q", q)
    cuda_f32("c", c, (C, L), q.device)
    if not bands_only:
        cuda_f32("u", u, (C, L), q.device)
        cuda_f32("lo", lo, (C, L), q.device)
    nb = _n_bands(L, w, v)
    lv = live_bytes(live, C, q.device)
    out = torch.empty((Q, C), dtype=q.dtype, device=q.device)
    if Q == 0 or C == 0:
        return out
    lib = _build.library()
    _build.check(lib.lb_enhanced_launch(
        q.data_ptr(), c.data_ptr(),
        None if bands_only else u.data_ptr(),
        None if bands_only else lo.data_ptr(),
        None if lv is None else lv.data_ptr(), out.data_ptr(),
        Q, C, L, nb, int(bands_only), stream_ptr(q.device)), "lb_enhanced")
    _build.COUNTS["lb_enhanced" if bands_only else "lb_enhanced_full"] += 1
    return out
