"""Shared neural layers: norms, soft-capping, rotary embeddings, MLPs,
embeddings (port of ``repro.models.layers``).

Conventions, as in the JAX package:
  * params are plain nested dicts of tensors (f32 at rest);
  * compute runs in the model's compute dtype (bf16 by default);
  * all shapes are ``(batch, seq, ...)``; heads axes are explicit.

Initialisers draw from an explicit ``torch.Generator`` with the JAX
initialisers' distributions (``lecun_normal`` is a normal truncated to
two standard deviations, rescaled to unit variance over ``fan_in``);
the numbers differ from JAX's, so the tests carry JAX's parameters over
with ``models.convert``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensor = torch.Tensor

# jax.nn.initializers.lecun_normal: truncated normal on [-2, 2] whose
# standard deviation is scaled back to 1 (the constant JAX divides by)
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape: tuple[int, ...], generator: torch.Generator,
                 device: torch.device) -> Tensor:
    """``jax.nn.initializers.lecun_normal()``: variance ``1 / fan_in``,
    truncated at two deviations.  As in JAX, ``fan_in`` is every axis but
    the last (a stack of experts ``(E, d, f)`` has ``fan_in = E d``)."""
    std = math.sqrt(shape[-1] / math.prod(shape)) / _TRUNC_STD
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.is_meta:   # shapes only: nothing to draw
        return t
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def normal(shape: tuple[int, ...], std: float, generator: torch.Generator,
           device: torch.device) -> Tensor:
    """``jax.nn.initializers.normal(std)``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t if t.is_meta else t.normal_(0.0, std, generator=generator)


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm scaled by ``1 + scale``, computed in f32 and cast back."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def softcap(x: Tensor, cap: float | None) -> Tensor:
    """Gemma-2 style logit soft-capping: ``cap * tanh(x / cap)``."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> Tensor:
    """(d_head/2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """Rotary embedding over split halves (not interleaved pairs).

    Args:
      x: (B, S, H, D) queries or keys.
      positions: (B, S) integer positions.
    """
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    ang = positions[..., None].float() * freqs                  # (B, S, D/2)
    return _rotate(x, ang)


def apply_mrope(x: Tensor, positions: Tensor, sections: tuple[int, ...],
                theta: float = 10000.0) -> Tensor:
    """Multimodal rotary embedding (Qwen2-VL): the head dim's frequency
    bands are split into (temporal, height, width) sections, each rotated
    by its own position stream.

    Args:
      x: (B, S, H, D).
      positions: (B, 3, S) integer positions (t, h, w); text tokens carry
        t == h == w, where M-RoPE is 1-D RoPE.
      sections: the split of D/2 into the three streams' bands (sums to
        D/2).
    """
    d_half = x.shape[-1] // 2
    if sum(sections) != d_half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to D/2 = "
                         f"{d_half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    ang_tri = positions[..., None].float() * freqs         # (B, 3, S, D/2)
    parts, start = [], 0
    for k, sec in enumerate(sections):
        parts.append(ang_tri[:, k, :, start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))                 # (B, S, D/2)


def _rotate(x: Tensor, ang: Tensor) -> Tensor:
    """Rotate the split halves of ``x`` (B, S, H, D) by angles (B, S, D/2),
    in f32, cast back."""
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / gated MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, device, d_model: int, d_ff: int,
             act: str) -> dict[str, Tensor]:
    p = {
        "wi": lecun_normal((d_model, d_ff), gen, device),
        "wo": lecun_normal((d_ff, d_model), gen, device),
    }
    if act == "silu":  # gated (SwiGLU-style)
        p["wg"] = lecun_normal((d_model, d_ff), gen, device)
    return p


def mlp_apply(p: dict[str, Tensor], x: Tensor, act: str,
              ctx=None) -> Tensor:
    """Gated only for ``silu``, as in the JAX package; under a mesh
    (``ctx``) the hidden units shard over tp."""
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if ctx is not None:
        h = ctx.con(h, "dp", None, "tp")
    if "wg" in p:
        h = activation(act)(x @ p["wg"].to(dt)) * h
    else:
        h = activation(act)(h)
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, device, vocab: int,
               d_model: int) -> Tensor:
    return normal((vocab, d_model), 0.02, gen, device)


def embed_lookup(table: Tensor, ids: Tensor, dtype) -> Tensor:
    return table[ids.long()].to(dtype)


def chunked_cross_entropy(x: Tensor, w_head: Tensor, labels: Tensor, *,
                          chunk: int = 512,
                          final_softcap_val: float | None = None,
                          mask: Tensor | None = None, ctx=None) -> Tensor:
    """Mean next-token cross-entropy without materialising ``(B, S, V)``
    f32 logits: x ``(B, S, D)``, w_head ``(D, V)``, labels ``(B, S)``
    (masked positions where ``mask`` is false), a 0-d f32 tensor.

    Loops over sequence chunks (S padded to a multiple of ``chunk``, the
    padding masked), so peak memory is ``(B, chunk, V)``; under autograd
    each chunk runs in ``torch.utils.checkpoint``, which recomputes its
    logits in backward -- otherwise every chunk's ``(B, chunk, V)`` f32
    residuals would stay alive for the backward and the chunking would
    save nothing for training.  Under a mesh (``ctx``) each chunk's logits
    shard their vocab over tp.
    """
    B, S, _ = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.bool, device=x.device)
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))

    def body(xi: Tensor, li: Tensor, mi: Tensor, w: Tensor) -> Tensor:
        logits = (xi @ w.to(xi.dtype)).float()
        if ctx is not None:
            logits = ctx.con(logits, "dp", None, "tp")
        logits = softcap(logits, final_softcap_val)
        lse = torch.logsumexp(logits, dim=-1)
        if ctx is None:
            gold = torch.gather(logits, -1, li[..., None].long())[..., 0]
        else:
            # the gold logit as a masked sum over the sharded vocab (one
            # term is nonzero, so the sum is exact)
            vocab = ctx.con(torch.arange(logits.shape[-1],
                                         device=logits.device), None)
            gold = torch.sum(torch.where(li[..., None].long() == vocab,
                                         logits, 0.0), dim=-1)
        return torch.sum(torch.where(mi, lse - gold, 0.0))

    grad = torch.is_grad_enabled() and (x.requires_grad
                                        or w_head.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S + pad, chunk):
        args = (x[:, s0:s0 + chunk], labels[:, s0:s0 + chunk],
                mask[:, s0:s0 + chunk], w_head)
        nll = (checkpoint(body, *args, use_reentrant=False) if grad
               else body(*args))
        tot = tot + nll
        cnt = cnt + torch.sum(args[2])
    return tot / torch.clamp(cnt, min=1.0)
