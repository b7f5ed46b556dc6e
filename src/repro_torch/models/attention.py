"""GQA attention with online (flash-style) softmax, sliding windows,
softcaps, RoPE and KV-cache decode (port of ``repro.models.attention``).

Two sites send attention through the K9 op (``impl="kernel"``, the
counterpart of JAX's ``"pallas"``), as in the JAX package: self-attention
without a cache, and a prefill that fills the whole cache (``S ==
Smax``), where attention over the cache is self-attention.  Every other
call (a prefill into a longer cache, every decode step) runs the plain
online-softmax attention over the cache with the unwritten slots masked.
With ``mrope_sections`` (Qwen2-VL) q and k are rotated by M-RoPE's three
position streams and the masks read the temporal stream, as in JAX; K9's
masks read implicit row positions, as JAX's Pallas kernel does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models.layers import apply_mrope, apply_rope, lecun_normal

Tensor = torch.Tensor


def attn_init(gen: torch.Generator, device, d_model: int, n_heads: int,
              n_kv_heads: int, d_head: int, *,
              qkv_bias: bool = False) -> dict[str, Tensor]:
    p = {
        "wq": lecun_normal((d_model, n_heads * d_head), gen, device),
        "wk": lecun_normal((d_model, n_kv_heads * d_head), gen, device),
        "wv": lecun_normal((d_model, n_kv_heads * d_head), gen, device),
        "wo": lecun_normal((n_heads * d_head, d_model), gen, device),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
            p[name] = torch.zeros(width * d_head, dtype=torch.float32,
                                  device=device)
    return p


def attn_apply(
    p: dict[str, Tensor],
    x: Tensor,                      # (B, S, d_model)
    positions: Tensor,              # (B, S), or (B, 3, S) with M-RoPE
    *,
    n_heads: int,
    n_kv_heads: int,
    d_head: int,
    causal: bool = True,
    window: int | None = None,
    score_cap: float | None = None,
    rope_theta: float = 10000.0,
    mrope_sections: tuple[int, ...] | None = None,
    cache: dict[str, Tensor] | None = None,
    cache_index: int | None = None,
    kv_chunk: int = 1024,
    impl: str = "chunked",   # "chunked" | "kernel"
) -> tuple[Tensor, dict[str, Tensor] | None]:
    """Self-attention (prefill) or cached decode step.

    With ``cache``, this call's k and v are written into it at
    ``cache_index`` in place (JAX returns an updated copy; the port
    writes the cache it was given, saving a copy per layer and step) and
    attention runs against the whole cache, unwritten slots masked.
    Returns (output, the cache or None).
    """
    if impl not in ("chunked", "kernel"):
        raise ValueError(f"unknown attention impl {impl!r}")
    B, S, _ = x.shape
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, S, n_heads, d_head)
    k = k.reshape(B, S, n_kv_heads, d_head)
    v = v.reshape(B, S, n_kv_heads, d_head)
    if mrope_sections is not None:
        q = apply_mrope(q, positions, mrope_sections, rope_theta)
        k = apply_mrope(k, positions, mrope_sections, rope_theta)
        positions = positions[:, 0, :]
    else:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    if cache is None:
        if impl == "kernel":
            out = ops.flash_attention_op(q, k, v, causal, window, score_cap)
        else:
            out = flash_attention_ref(q, k, v, causal, window, score_cap,
                                      q_pos=positions, kv_pos=positions,
                                      kv_chunk=kv_chunk)
    else:
        ck, cv = cache["k"], cache["v"]
        Smax = ck.shape[1]
        ck[:, cache_index:cache_index + S] = k.to(ck.dtype)
        cv[:, cache_index:cache_index + S] = v.to(cv.dtype)
        if S == Smax and impl == "kernel":
            # full-cache prefill: attention over the cache is
            # self-attention over this call's (un-cast) k and v
            out = ops.flash_attention_op(q, k, v, causal, window, score_cap)
        else:
            slot_pos = torch.arange(Smax, device=x.device)
            kv_valid = (slot_pos < cache_index + S)[None, :].expand(B, Smax)
            kv_pos = slot_pos[None, :].expand(B, Smax)
            out = flash_attention_ref(q, ck.to(dt), cv.to(dt), causal,
                                      window, score_cap, q_pos=positions,
                                      kv_pos=kv_pos, kv_valid=kv_valid,
                                      kv_chunk=kv_chunk)
    out = out.reshape(B, S, n_heads * d_head)
    return out @ p["wo"].to(dt), cache


def init_cache(batch: int, max_len: int, n_kv_heads: int, d_head: int,
               dtype=torch.bfloat16, device=None) -> dict[str, Tensor]:
    shape = (batch, max_len, n_kv_heads, d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
