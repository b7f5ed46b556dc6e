"""GQA attention with online (flash-style) softmax, sliding windows,
softcaps, RoPE and KV-cache decode (port of ``repro.models.attention``).

Two sites send attention through the K9 op (``impl="kernel"``, the
counterpart of JAX's ``"pallas"``), as in the JAX package: self-attention
without a cache, and a prefill that fills the whole cache (``S ==
Smax``), where attention over the cache is self-attention.  At the same
two sites ``impl="bypass"`` is the dry-run's stand-in for K9 (JAX's
``"bypass"``, ``launch.dryrun``): the output's shape with no scores, as
K9 keeps none in memory; it computes no attention.  Every other
call (a prefill into a longer cache, every decode step) runs the plain
online-softmax attention over the cache with the unwritten slots masked.
With ``mrope_sections`` (Qwen2-VL) q and k are rotated by M-RoPE's three
position streams and the masks read the temporal stream, as in JAX; K9's
masks read implicit row positions, as JAX's Pallas kernel does.  Under a
mesh, RoPE and attention run on each rank's local heads (``attn_apply``).
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


def _kv_for_heads(t: Tensor, hl: int, n_heads: int, n_kv_heads: int,
                  r: int) -> Tensor:
    """The kv heads (B, S, kl, D) that rank ``r``'s ``hl`` local q heads,
    global heads ``[r hl, (r + 1) hl)``, read: ``t`` itself when its heads
    are sharded with the q heads (or nothing is sharded); when ``t`` holds
    every kv head (``wk`` / ``wv`` replicated because kv does not divide
    the tp size), the heads ``h // group`` of those q heads, so that K9,
    which pairs local q head i with kv head ``i // (hl / kl)``, reads the
    reference's pairs."""
    g = n_heads // n_kv_heads
    if t.shape[2] * g == hl:
        return t
    if hl % g == 0:
        return t[:, :, r * hl // g:(r + 1) * hl // g]
    if g % hl == 0:
        return t[:, :, r * hl // g:r * hl // g + 1]
    idx = (r * hl + torch.arange(hl, device=t.device)) // g
    return t[:, :, idx]


def _bypass(v: Tensor, hl: int, positions: Tensor) -> Tensor:
    """The dry-run's stand-in for attention (JAX ``impl="bypass"``): the
    output's shape and dtype, each q head a copy of its kv head's ``v``
    times one, and no scores."""
    one = (positions[..., None, None] * 0 + 1).to(v.dtype)
    return torch.repeat_interleave(v, hl // v.shape[2], dim=2) * one


def _attend(q: Tensor, k: Tensor, v: Tensor, positions: Tensor,
            ck: Tensor | None, cv: Tensor | None, *, n_heads: int,
            n_kv_heads: int, rank: int, causal: bool, window: int | None,
            score_cap: float | None, rope_theta: float,
            mrope_sections: tuple[int, ...] | None,
            cache_index: int | None, kv_chunk: int, impl: str):
    """RoPE and attention on (local) heads: q (B, S, hl, D), k / v
    (B, S, kl, D), positions (B, S) or (B, 3, S); with a cache, k and v
    are written into ``ck`` / ``cv`` at ``cache_index`` in place.  Returns
    (out (B, S, hl, D), ck, cv)."""
    B, S, hl, _ = q.shape
    dt = q.dtype
    if mrope_sections is not None:
        q = apply_mrope(q, positions, mrope_sections, rope_theta)
        k = apply_mrope(k, positions, mrope_sections, rope_theta)
        positions = positions[:, 0, :]
    else:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    def heads(t):
        return _kv_for_heads(t, hl, n_heads, n_kv_heads, rank)

    if ck is None:
        if impl == "kernel":
            out = ops.flash_attention_op(q, heads(k), heads(v), causal,
                                         window, score_cap)
        elif impl == "bypass":
            out = _bypass(heads(v), hl, positions)
        else:
            out = flash_attention_ref(q, heads(k), heads(v), causal, window,
                                      score_cap, q_pos=positions,
                                      kv_pos=positions, kv_chunk=kv_chunk)
        return out, None, None
    Smax = ck.shape[1]
    ck[:, cache_index:cache_index + S] = k.to(ck.dtype)
    cv[:, cache_index:cache_index + S] = v.to(cv.dtype)
    if S == Smax and impl == "kernel":
        # full-cache prefill: attention over the cache is self-attention
        # over this call's (un-cast) k and v
        out = ops.flash_attention_op(q, heads(k), heads(v), causal, window,
                                     score_cap)
    elif S == Smax and impl == "bypass":
        out = _bypass(heads(v), hl, positions)
    else:
        slot_pos = torch.arange(Smax, device=q.device)
        kv_valid = (slot_pos < cache_index + S)[None, :].expand(B, Smax)
        kv_pos = slot_pos[None, :].expand(B, Smax)
        out = flash_attention_ref(q, heads(ck).to(dt), heads(cv).to(dt),
                                  causal, window, score_cap,
                                  q_pos=positions, kv_pos=kv_pos,
                                  kv_valid=kv_valid, kv_chunk=kv_chunk)
    return out, ck, cv


def _split_heads(t: Tensor, n: int, d_head: int, ctx) -> Tensor:
    """(B, S, n d_head) -> (B, S, n, d_head); under a mesh the heads shard
    over tp (replicated when n does not divide the tp size)."""
    B, S, _ = t.shape
    if ctx is None:
        return t.reshape(B, S, n, d_head)
    if n % ctx.size(ctx.tp):
        t = ctx.con(t, "dp", None, None)
    return ctx.con(t.reshape(B, S, n, d_head), "dp", None, "tp", None)


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
    impl: str = "chunked",   # "chunked" | "kernel" | "bypass" (dry-run)
    ctx=None,
) -> tuple[Tensor, dict[str, Tensor] | None]:
    """Self-attention (prefill) or cached decode step.

    With ``cache``, this call's k and v are written into it at
    ``cache_index`` in place (JAX returns an updated copy; the port
    writes the cache it was given, saving a copy per layer and step) and
    attention runs against the whole cache, unwritten slots masked.
    Returns (output, the cache or None).

    Under a mesh (``ctx``, DTensor activations) the heads shard over tp
    and RoPE and attention run on each rank's local heads
    (``sharding.shard_map_compat``), K9 included; when kv does not divide
    the tp size, k and v stay replicated and each rank reads the kv heads
    of its q heads.  The cache is redistributed to k's placement for the
    write, and back to its own after.
    """
    if impl not in ("chunked", "kernel", "bypass"):
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
    q = _split_heads(q, n_heads, d_head, ctx)
    k = _split_heads(k, n_kv_heads, d_head, ctx)
    v = _split_heads(v, n_kv_heads, d_head, ctx)
    opts = dict(n_heads=n_heads, n_kv_heads=n_kv_heads, causal=causal,
                window=window, score_cap=score_cap, rope_theta=rope_theta,
                mrope_sections=mrope_sections, cache_index=cache_index,
                kv_chunk=kv_chunk, impl=impl)
    ck = cv = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
    if ctx is None:
        out, _, _ = _attend(q, k, v, positions, ck, cv, rank=0, **opts)
    else:
        from repro_torch.distributed.sharding import (placed_as,
                                                      shard_map_compat)

        kv_pl = tuple(k.placements)
        cpl = None if cache is None else kv_pl
        island = shard_map_compat(
            lambda *a: _attend(*a, rank=ctx.rank(ctx.tp), **opts),
            mesh=ctx.mesh,
            in_specs=(tuple(q.placements), kv_pl, kv_pl,
                      tuple(positions.placements), cpl, cpl),
            out_specs=[tuple(q.placements), cpl, cpl])
        out, wk, wv = island(q, k, v, positions, ck, cv)
        if cache is not None:
            cache["k"], cache["v"] = placed_as(wk, ck), placed_as(wv, cv)
    out = out.reshape(B, S, n_heads * d_head)
    if ctx is not None:
        out = ctx.con(out, "dp", None, "tp")
    out = out @ p["wo"].to(dt)
    if ctx is not None:
        out = ctx.con(out, "dp", None, None)
    return out, cache


def init_cache(batch: int, max_len: int, n_kv_heads: int, d_head: int,
               dtype=torch.bfloat16, device=None) -> dict[str, Tensor]:
    shape = (batch, max_len, n_kv_heads, d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
