"""K10 wrapper: the Mamba-1 selective scan on the card
(csrc/mamba_scan.cu).

Replaces ``src/repro/kernels/mamba_scan.py:mamba_scan_pallas``
(``_mamba_scan_kernel``).  Bound on this card: bytes, the inputs and
outputs once, ``B S (2C + 2N) 4 + B S C 4``: ~0.8 GB, ~0.24 ms at
falcon-mamba-7b's B = 4, S = 2048, C = 8192, N = 16.  Design: states
across lanes -- a group of G lanes per (batch row, channel) (G = 2 at
N = 16), lane k carrying the 8 states from ``8 k`` in registers through
the whole sequence, so ``N <= 256``; the group is skewed one step a lane
and passes each step's running sum down by one shuffle, so y keeps the
plain version's n-ordered sum; blocks copy chunks of 32 steps of the
shared B and C rows and of their own delta and u columns to shared
memory by ``cp.async``, the next chunk's while this one runs.  Past
``MAX_STATE`` the wrapper picks the wide-state form by N (launch count
``mamba_scan_wide``): the same kernel at G = 32 in one launch of
``ceil(N / 256)`` passes over the sequence, 256 states a pass, each
step's sum carried from pass to pass through y, so it stays bit-equal for
any N.  Forward only: inputs that require a gradient are refused.
Training reaches the kernel through ``kernels.ops.mamba_scan_op``'s
autograd Function, which hands it detached inputs and recomputes the
backward through the chunked scan, as ``repro.kernels.ops._mamba_bwd``
does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import cuda_f32, stream_ptr

Tensor = torch.Tensor

# the largest N whose state h[N] lives in the registers of one group of at
# most 32 lanes, 8 a lane; past it the wide-state form runs
MAX_STATE = 256


def mamba_scan_cuda(delta: Tensor, u: Tensor, A: Tensor, Bmat: Tensor,
                    Cmat: Tensor, h0: Tensor) -> tuple[Tensor, Tensor]:
    """delta and u ``(B, S, C)``, A ``(C, N)``, B and C ``(B, S, N)``, h0
    ``(B, C, N)``, all float32 ``-> (y (B, S, C), hT (B, C, N))`` on the
    card."""
    if delta.dim() != 3 or A.dim() != 2:
        raise ValueError("delta, A: expected (B, S, C) and (C, N)")
    Bsz, S, C = delta.shape
    N = A.shape[1]
    cuda_f32("delta", delta)
    dev = delta.device
    cuda_f32("u", u, (Bsz, S, C), dev)
    cuda_f32("A", A, (C, N), dev)
    cuda_f32("Bmat", Bmat, (Bsz, S, N), dev)
    cuda_f32("Cmat", Cmat, (Bsz, S, N), dev)
    cuda_f32("h0", h0, (Bsz, C, N), dev)
    for name, x in (("delta", delta), ("u", u), ("A", A), ("Bmat", Bmat),
                    ("Cmat", Cmat), ("h0", h0)):
        if x.requires_grad:
            raise ValueError(f"{name}: the kernel is forward-only; its "
                             "input may not require a gradient")
    if N < 1:
        raise ValueError(f"ssm state N = {N}: expected N >= 1")
    y = torch.empty_like(delta)
    hT = torch.empty_like(h0)
    if Bsz == 0 or C == 0:
        return y, hT
    lib = _build.library()
    launch, name = ((lib.mamba_scan_launch, "mamba_scan") if N <= MAX_STATE
                    else (lib.mamba_scan_wide_launch, "mamba_scan_wide"))
    _build.check(launch(
        delta.data_ptr(), u.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
        Cmat.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(), Bsz, S,
        C, N, stream_ptr(dev)), name)
    _build.COUNTS[name] += 1
    return y, hT
