"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``,
plus the plain versions of the flash-attention and selective-scan
kernels, which the JAX package keeps in ``models/attention.py`` and
``kernels/mamba_scan.py``).

Each ``*_ref`` has its kernel's semantics exactly: the same shapes, the
same ``live`` / ``bands_only`` / ``cutoff`` / ``perm`` / masking rules.
The CPU path of ``kernels/ops.py`` runs these, the tests hold them against the
JAX package, and ``chip_smoke.py`` holds each kernel against them on the
card.
"""

from __future__ import annotations

import torch

from repro_torch.core import envelopes as _env
from repro_torch.core import lower_bounds as _lb
from repro_torch.core.dtw import dtw_band_blocked
from repro_torch.kernels.tiling import apply_pair_perm

Tensor = torch.Tensor

_INF = float("inf")


def _mask_dead(out: Tensor, live: Tensor | None) -> Tensor:
    """Dead entries of ``live`` (broadcast along the last axis) become
    ``-inf``, the running-max identity."""
    if live is None:
        return out
    live = torch.as_tensor(live, device=out.device).bool()
    return torch.where(live, out, -_INF)


def envelope_ref(b: Tensor, w: int) -> tuple[Tensor, Tensor]:
    """``(N, L) -> ((N, L), (N, L))`` upper/lower envelopes."""
    return _env.envelope(b, min(w, b.shape[-1]))


def lb_keogh_ref(q: Tensor, u: Tensor, lo: Tensor, *,
                 chunk: int = 512) -> Tensor:
    """``(Q, L) x (C, L)`` envelopes ``-> (Q, C)`` LB_KEOGH matrix.

    Candidates are taken ``chunk`` at a time so the ``(Q, chunk, L)``
    intermediate stays bounded; each entry's sum over L is the same
    whatever the chunk.
    """
    outs = [_lb.lb_keogh_matrix(q, u[s:s + chunk], lo[s:s + chunk])
            for s in range(0, u.shape[0], chunk)]
    if not outs:
        return q.new_zeros((q.shape[0], 0))
    return torch.cat(outs, dim=1)


def sketch_operands(qbar: Tensor, sk_scale, seg_sizes) -> tuple[Tensor,
                                                                Tensor]:
    """The sketch bound's scaled-units operands: ``qs = qbar / scale``
    ``(Q, S)`` and ``wseg = n_j * scale * scale`` ``(S,)``, computed as
    the JAX package computes them (a true division, then two products)."""
    scale = torch.as_tensor(sk_scale, dtype=torch.float32,
                            device=qbar.device)
    qs = qbar.to(torch.float32) / scale
    wseg = torch.as_tensor(seg_sizes, dtype=torch.float32,
                           device=qbar.device) * scale * scale
    return qs.contiguous(), wseg.contiguous()


def sketch_bound_scaled(qs: Tensor, sk_lo: Tensor, sk_hi: Tensor,
                        wseg: Tensor) -> Tensor:
    """``(Q, S) x (N, S) int8 -> (Q, N)`` sketch bound in scaled units:
    ``sum_j wseg_j * max(qs_j - hi_j, lo_j - qs_j, 0)^2``.

    The segments are summed in the fixed order ``j = 0 .. S-1`` as
    ``acc + (wseg_j * d) * d``, each product and sum rounded on its own;
    the sketch kernel (csrc/sketch.cu) does the same, so the two are
    bit-equal.
    """
    lo = sk_lo.to(torch.float32)
    hi = sk_hi.to(torch.float32)
    acc = torch.zeros((qs.shape[0], lo.shape[0]), dtype=torch.float32,
                      device=qs.device)
    for j in range(qs.shape[1]):
        qj = qs[:, j:j + 1]
        d = torch.clamp(torch.maximum(qj - hi[None, :, j],
                                      lo[None, :, j] - qj), min=0.0)
        acc = acc + (wseg[j] * d) * d
    return acc


def sketch_bound_ref(qbar: Tensor, sk_lo: Tensor, sk_hi: Tensor, sk_scale,
                     seg_sizes) -> Tensor:
    """``(Q, S) f32 x (N, S) int8 -> (Q, N)`` tier-(-1) sketch bounds:
    the quantised segment-reduced LB_Keogh of ``search/index.py``, in the
    scaled-units form of ``repro.kernels.ref.sketch_bound_ref`` (the int8
    cells are compared without dequantising)."""
    qs, wseg = sketch_operands(qbar, sk_scale, seg_sizes)
    return sketch_bound_scaled(qs, sk_lo, sk_hi, wseg)


def lb_enhanced_ref(q: Tensor, c: Tensor, u: Tensor, lo: Tensor, w: int,
                    v: int, *, live: Tensor | None = None,
                    bands_only: bool = False) -> Tensor:
    """``(Q, L) x (C, L) -> (Q, C)`` LB_ENHANCED^V or its bands-only tier.

    ``live`` (``(C,)``): dead candidates return ``-inf`` down their whole
    column.  The plain version computes everything and masks.
    """
    if bands_only:
        out = _lb.lb_enhanced_bands(q[:, None, :], c[None, :, :], w, v)
    else:
        out = _lb.lb_enhanced_matrix(q, c, u, lo, w, v)
    return _mask_dead(out, live)


def lb_enhanced_pairwise_ref(q: Tensor, c: Tensor, u: Tensor, lo: Tensor,
                             w: int, v: int, *, live: Tensor | None = None,
                             bands_only: bool = False) -> Tensor:
    """Pairwise ``(P, L) x (P, L) -> (P,)`` LB_ENHANCED^V: row ``p`` of
    the queries with row ``p`` of the candidates.  ``live`` (``(P,)``):
    dead slots return ``-inf``."""
    if bands_only:
        out = _lb.lb_enhanced_bands(q, c, w, v)
    else:
        out = _lb.lb_enhanced_env(q, c, u, lo, w, v)
    return _mask_dead(out, live)


def dtw_band_ref(a: Tensor, b: Tensor, w: int | None = None,
                 cutoff=None, *, row_block: int | None = None,
                 perm: Tensor | None = None,
                 tile_p: int | None = None) -> Tensor:
    """Pairwise banded DTW ``(P, L), (P, L) -> (P,)`` with the kernel's
    per-pair ``cutoff`` and row-block abandon rule.

    ``perm`` is the pair-packing gather (a no-op on results); ``tile_p``
    is packing geometry and is accepted and ignored, so the engine can
    make one call shape on both routes.
    """
    del tile_p
    if perm is not None:
        return apply_pair_perm(
            lambda x, y, c: dtw_band_ref(x, y, w, c, row_block=row_block),
            perm, a, b, cutoff,
        )
    return dtw_band_blocked(a, b, w, cutoff, row_block=row_block)


# the plain selective scan's chunk: at most this many steps, and about
# this many bytes a (T, B, C, N) tensor
_SCAN_CHUNK_STEPS = 4096
_SCAN_CHUNK_BYTES = 1 << 30

# large negative for masking in f32 (finite, as in the JAX package)
_NEG = -2.3819763e38


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                        window: int | None = None,
                        score_cap: float | None = None, *,
                        q_pos: Tensor | None = None,
                        kv_pos: Tensor | None = None,
                        kv_valid: Tensor | None = None,
                        kv_chunk: int = 1024) -> Tensor:
    """Online-softmax GQA attention over KV chunks, in f32: q ``(B, Sq,
    Hq, D)``, k and v ``(B, Skv, Hkv, D)`` ``-> (B, Sq, Hq, D)`` in q's
    dtype (``repro.models.attention.flash_attention``).

    Positions default to the kernel's implicit ones (row i attends key
    rows ``<= i``); ``kv_valid`` ``(B, Skv)`` masks unwritten cache
    slots.  q is scaled by ``D**-0.5`` in f32 before the product, the
    soft cap comes before the mask, masked scores take the finite
    ``_NEG`` and ``l`` is floored at ``1e-30`` in the final divide.
    """
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(Sq, device=dev).expand(B, Sq)
    if kv_pos is None:
        kv_pos = torch.arange(Skv, device=dev).expand(B, Skv)
    qf = (q.float() * D ** -0.5).reshape(B, Sq, Hkv, g, D)
    qf = qf.permute(0, 2, 3, 1, 4).reshape(B, Hkv, g * Sq, D)
    m = torch.full((B, Hkv, g * Sq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, g * Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, g * Sq, D), dtype=torch.float32, device=dev)
    # (B, 1, g*Sq, 1): each folded row's query position
    rows_pos = q_pos[:, None, :].expand(B, g, Sq).reshape(B, 1, g * Sq, 1)
    for c0 in range(0, Skv, kv_chunk):
        k_i = k[:, c0:c0 + kv_chunk].float().permute(0, 2, 3, 1)  # (B,Hkv,D,C)
        v_i = v[:, c0:c0 + kv_chunk].float().permute(0, 2, 1, 3)  # (B,Hkv,C,D)
        s = torch.matmul(qf, k_i)                        # (B, Hkv, gSq, C)
        if score_cap is not None:
            s = score_cap * torch.tanh(s / score_cap)
        dp = rows_pos - kv_pos[:, None, None, c0:c0 + kv_chunk]
        ok = torch.ones_like(dp, dtype=torch.bool)
        if kv_valid is not None:
            ok = ok & kv_valid[:, None, None, c0:c0 + kv_chunk]
        if causal:
            ok = ok & (dp >= 0)
        if window is not None:
            ok = ok & (dp < window)
        s = torch.where(ok, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(p, v_i)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]     # (B, Hkv, gSq, D)
    out = out.reshape(B, Hkv, g, Sq, D).permute(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def mamba_scan_ref(delta: Tensor, u: Tensor, A: Tensor, Bmat: Tensor,
                   Cmat: Tensor, h0: Tensor) -> tuple[Tensor, Tensor]:
    """Selective scan, in time order: ``h = exp(d A) h + (d u) B``,
    ``y = sum_n h C``.  delta and u ``(B, S, C)``, A ``(C, N)``, B and C
    ``(B, S, N)``, h0 ``(B, C, N)`` ``-> (y (B, S, C), hT (B, C, N))``
    (``repro.kernels.mamba_scan``'s kernel, one step at a time).

    The state update is ``(exp(d A) * h) + ((d * u) * B)`` and the N-sum
    runs ``n = 0 .. N-1`` as ``acc + h_n C_n``, each product and sum
    rounded on its own; the selective-scan kernel (csrc/mamba_scan.cu)
    does the same, so the two agree bit for bit where their ``exp``s do.
    Only the recurrence runs step by step: ``exp(d A)``, ``(d u) B`` and
    the N-sum are the same elementwise operations taken over a chunk of
    steps at once (``_SCAN_CHUNK_STEPS`` steps, fewer where a chunk's
    ``(T, B, C, N)`` tensors would pass ``_SCAN_CHUNK_BYTES``), so a step
    costs two launches on the card.
    """
    Bsz, S, C = delta.shape
    N = A.shape[1]
    h = h0.float()
    y = torch.empty((Bsz, S, C), dtype=delta.dtype, device=delta.device)
    T = max(1, min(S, _SCAN_CHUNK_STEPS,
                   _SCAN_CHUNK_BYTES // max(1, 4 * Bsz * C * N)))
    for s0 in range(0, S, T):
        def steps(x):                                    # (T, B, ...)
            return x[:, s0:s0 + T].transpose(0, 1).contiguous()

        d = steps(delta)                                 # (T, B, C)
        a = torch.exp(d[..., None] * A)                  # (T, B, C, N)
        bx = (d * steps(u))[..., None] * steps(Bmat)[:, :, None, :]
        hs = []
        for a_t, bx_t in zip(a.unbind(0), bx.unbind(0)):
            h = a_t * h + bx_t
            hs.append(h)
        hs = torch.stack(hs)
        cm = steps(Cmat)                                 # (T, B, N)
        acc = torch.zeros_like(d)
        for n in range(N):
            acc = acc + hs[..., n] * cm[..., n, None]
        y[:, s0:s0 + T] = acc.transpose(0, 1)
    return y, h.to(h0.dtype)
