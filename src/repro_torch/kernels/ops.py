"""Public kernel entry points, dispatched on the tensor's device (port of
``repro.kernels.ops``).

On a CPU tensor each op runs its kernel's plain PyTorch version
(``kernels/ref.py``); on a CUDA tensor it launches the hand-written
kernel, or raises when the kernel does not take the arguments.  There is
no fallback from the card to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.dtw_band import dtw_band_cuda, dtw_band_route
from repro_torch.kernels.envelope import envelope_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.lb_enhanced import lb_enhanced_cuda
from repro_torch.kernels.lb_enhanced_pairwise import lb_enhanced_pairwise_cuda
from repro_torch.kernels.lb_keogh import lb_keogh_cuda
from repro_torch.kernels.mamba_scan import mamba_scan_cuda
from repro_torch.kernels.sketch import sketch_bound_cuda
from repro_torch.kernels.tiling import apply_pair_perm

Tensor = torch.Tensor

# Calls of the LM substrate's two ops, on either route (the kernels'
# launch counts are ``_build.COUNTS``): the model's routing is read from
# these on the CPU too, where no kernel launches.
OP_CALLS: dict[str, int] = {"flash_attention": 0, "mamba_scan": 0}


def _on_card(x: Tensor) -> bool:
    """``True`` for a CUDA tensor, ``False`` for a CPU one; anything else
    has neither route."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel route for a tensor on {x.device}")


def envelope_op(b: Tensor, w: int) -> tuple[Tensor, Tensor]:
    """Sakoe-Chiba envelopes ``(N, L) -> (U, Lo)``; a ``(L,)`` series gives
    ``(L,)`` envelopes."""
    squeeze = b.dim() == 1
    if squeeze:
        b = b[None]
    if _on_card(b):
        u, lo = envelope_cuda(b, w)
    else:
        u, lo = ref.envelope_ref(b, w)
    return (u[0], lo[0]) if squeeze else (u, lo)


def lb_keogh_op(q: Tensor, u: Tensor, lo: Tensor) -> Tensor:
    """``(Q, L) x (C, L)`` envelopes ``-> (Q, C)`` LB_KEOGH matrix."""
    fn = lb_keogh_cuda if _on_card(q) else ref.lb_keogh_ref
    return fn(q, u, lo)


def sketch_bound_op(qbar: Tensor, sk_lo: Tensor, sk_hi: Tensor, sk_scale,
                    seg_sizes) -> Tensor:
    """``(Q, S) f32 x (N, S) int8 -> (Q, N)`` tier-(-1) sketch bounds
    (search/index.py documents the store).  The operands are rewritten
    into the kernel's scaled units here, on the tensors' device."""
    if not _on_card(qbar):
        return ref.sketch_bound_ref(qbar, sk_lo, sk_hi, sk_scale, seg_sizes)
    qs, wseg = ref.sketch_operands(qbar, sk_scale, seg_sizes)
    return sketch_bound_cuda(qs, sk_lo, sk_hi, wseg)


def lb_enhanced_op(q: Tensor, c: Tensor, u: Tensor, lo: Tensor, w: int,
                   v: int, *, live: Tensor | None = None,
                   bands_only: bool = False) -> Tensor:
    """``(Q, L) x (C, L) -> (Q, C)`` LB_ENHANCED^V (or its bands-only
    tier); ``live`` (``(C,)``) gives dead candidates ``-inf``."""
    fn = lb_enhanced_cuda if _on_card(q) else ref.lb_enhanced_ref
    return fn(q, c, u, lo, w, v, live=live, bands_only=bands_only)


def lb_enhanced_pairwise_op(q: Tensor, c: Tensor, u: Tensor, lo: Tensor,
                            w: int, v: int, *, live: Tensor | None = None,
                            bands_only: bool = False) -> Tensor:
    """``(P, L) x (P, L) -> (P,)`` pairwise LB_ENHANCED^V over packed
    survivor rows; ``live`` (``(P,)``) gives dead slots ``-inf``."""
    fn = (lb_enhanced_pairwise_cuda if _on_card(q)
          else ref.lb_enhanced_pairwise_ref)
    return fn(q, c, u, lo, w, v, live=live, bands_only=bands_only)


def dtw_band_op(a: Tensor, b: Tensor, w: int | None = None, cutoff=None,
                *, early_exit: bool = True, perm: Tensor | None = None,
                tile_p: int | None = None) -> Tensor:
    """Pairwise banded DTW ``(P, L) x (P, L) -> (P,)``.

    ``cutoff`` (scalar or ``(P,)``): pairs whose frontier minimum passes
    it at a row-block boundary return ``+inf``; below it values are
    exact.  ``early_exit=False`` tests the frontier at every
    anti-diagonal instead and skips nothing (K6, the baseline; same
    results).  ``perm`` gathers the pairs into that order before the call
    and scatters the results back (no effect on results).  ``tile_p`` is
    the JAX kernel's pair-tile cap; these kernels run one pair per block,
    so it is accepted and ignored.

    On the card ``dtw_band_route(L, w)`` picks K4 (K6), in the form
    ``k4_form(L, w)`` picks, while the band's state fits a block's shared
    memory and K5 past that; past the
    crossover ``early_exit=False`` is ignored, as in the JAX package.
    Every ``(L, w)`` runs on the card; none falls back to the plain
    version.  On the CPU the plain versions run: ``ref.dtw_band_ref``, or
    ``dtw_band_blocked(..., row_block=1)`` for ``early_exit=False``.
    """
    del tile_p
    if perm is not None:
        return apply_pair_perm(
            lambda x, y, c: dtw_band_op(x, y, w, c, early_exit=early_exit),
            perm, a, b, cutoff)
    stream = dtw_band_route(a.shape[-1], w) == "stream"
    early_exit = early_exit or stream
    if _on_card(a):
        out = dtw_band_cuda(a, b, w, cutoff, early_exit=early_exit,
                            stream=stream)
    else:
        out = ref.dtw_band_ref(a, b, w, cutoff,
                               row_block=None if early_exit else 1)
    # fault seam (search/guards.py): the plain versions the degradation
    # ladder reruns with do not pass through here, so an injected kernel
    # fault cannot reach the rerun.  Imported here: the kernels package
    # imports without the search package.
    from repro_torch.search.guards import fault_hook

    hook = fault_hook("dtw_out")
    return out if hook is None else hook(out)


def _wants_grad(*xs: Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _FlashAttention(torch.autograd.Function):
    """K9 under autograd: the forward is the kernel (the plain version on
    a CPU tensor) on detached inputs; the backward recomputes through the
    plain version, ``ref.flash_attention_ref`` with implicit positions and
    ``kv_chunk`` 1024, as the reference's ``custom_vjp``
    (``repro.kernels.ops._fa_bwd``) does through its chunked attention."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, score_cap):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, score_cap)
        return _flash_forward(q.detach(), k.detach(), v.detach(),
                              *ctx.args)

    @staticmethod
    def backward(ctx, ct):
        xs = [x.detach().requires_grad_(need) for x, need in
              zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = ref.flash_attention_ref(*xs, *ctx.args, kv_chunk=1024)
            want = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad(out, want, ct))
        return (*(next(got) if x.requires_grad else None for x in xs),
                None, None, None)


def _flash_forward(q, k, v, causal, window, score_cap):
    if _on_card(q):
        return flash_attention_cuda(q, k, v, causal, window, score_cap)
    return ref.flash_attention_ref(q, k, v, causal, window, score_cap)


def flash_attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                       window: int | None = None,
                       score_cap: float | None = None) -> Tensor:
    """Fused self-attention forward, q ``(B, Sq, Hq, D)`` x k, v ``(B,
    Skv, Hkv, D)`` ``-> (B, Sq, Hq, D)``, positions implicit (K9).  When
    grad mode is on and an input requires a gradient, it runs through
    ``_FlashAttention`` (the kernel forward, the plain version's
    backward); otherwise it calls the kernel directly."""
    OP_CALLS["flash_attention"] += 1
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, score_cap)
    return _flash_forward(q, k, v, causal, window, score_cap)


class _MambaScan(torch.autograd.Function):
    """K10 under autograd: the forward is the kernel (the plain version on
    a CPU tensor) on detached inputs; the backward recomputes through
    ``models.mamba._chunked_selective_scan`` with chunks of 256, as the
    reference's ``custom_vjp`` (``repro.kernels.ops._mamba_bwd``) does."""

    @staticmethod
    def forward(ctx, delta, u, A, Bmat, Cmat, h0):
        ctx.save_for_backward(delta, u, A, Bmat, Cmat, h0)
        return _mamba_forward(*(x.detach() for x in
                                (delta, u, A, Bmat, Cmat, h0)))

    @staticmethod
    def backward(ctx, gy, gh):
        # imported here: models/mamba.py imports this module
        from repro_torch.models.mamba import _chunked_selective_scan

        xs = [x.detach().requires_grad_(need) for x, need in
              zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, h = _chunked_selective_scan(*xs, chunk=256)
            want = [x for x in xs if x.requires_grad]
            got = iter(torch.autograd.grad((y, h), want, (gy, gh)))
        return tuple(next(got) if x.requires_grad else None for x in xs)


def _mamba_forward(delta, u, A, Bmat, Cmat, h0):
    if _on_card(delta):
        return mamba_scan_cuda(delta, u, A, Bmat, Cmat, h0)
    return ref.mamba_scan_ref(delta, u, A, Bmat, Cmat, h0)


def mamba_scan_op(delta: Tensor, u: Tensor, A: Tensor, Bmat: Tensor,
                  Cmat: Tensor, h0: Tensor) -> tuple[Tensor, Tensor]:
    """Fused selective scan ``-> (y (B, S, C), h_final (B, C, N))`` (K10).
    When grad mode is on and an input requires a gradient, it runs
    through ``_MambaScan`` (the kernel forward, the chunked scan's
    backward); otherwise it calls the kernel directly."""
    OP_CALLS["mamba_scan"] += 1
    xs = (delta, u, A, Bmat, Cmat, h0)
    if _wants_grad(*xs):
        return _MambaScan.apply(*xs)
    return _mamba_forward(*xs)
