"""Transformer/Mamba block assembly driven by ``LayerSpec`` (port of
``repro.models.blocks``).

A block = pre-norm mixer (attention or Mamba) + residual, then pre-norm
FFN (routed MoE, else a dense MLP where ``d_ff > 0``) + residual.
Routing kept from the JAX package (``blocks.py:83,91``): a call with
``S == 1`` (every decode step) runs the plain ``"chunked"`` attention and
``"scan"`` paths whatever the model's impl, so no kernel runs in a decode
step.  Under a mesh (``ctx``) every sublayer gets the constraint helper,
the MoE its mesh and data axes, and the block's output is constrained to
the residual stream's spec (``blocks.py:108``).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.attention import attn_apply, attn_init, init_cache
from repro_torch.models.layers import mlp_apply, mlp_init, rms_norm
from repro_torch.models.mamba import init_mamba_cache, mamba_apply, mamba_init
from repro_torch.models.moe import moe_apply, moe_init

Tensor = torch.Tensor


def layer_init(gen: torch.Generator, device, cfg: ArchConfig,
               spec: LayerSpec) -> dict[str, Any]:
    p: dict[str, Any] = {"norm1": torch.zeros(cfg.d_model, device=device)}
    if spec.mixer == "attn":
        p["attn"] = attn_init(gen, device, cfg.d_model, cfg.n_heads,
                              cfg.n_kv_heads, cfg.head_dim,
                              qkv_bias=cfg.qkv_bias)
    else:
        p["mamba"] = mamba_init(gen, device, cfg.d_model, cfg.d_inner_,
                                cfg.ssm_state, cfg.dt_rank_, cfg.conv_width)
    if spec.moe:
        p["norm2"] = torch.zeros(cfg.d_model, device=device)
        p["moe"] = moe_init(gen, device, cfg.d_model,
                            cfg.d_expert or cfg.d_ff, cfg.n_experts_padded,
                            cfg.n_shared_experts, cfg.act)
    elif cfg.d_ff > 0:
        p["norm2"] = torch.zeros(cfg.d_model, device=device)
        p["mlp"] = mlp_init(gen, device, cfg.d_model, cfg.d_ff, cfg.act)
    return p


def layer_apply(
    cfg: ArchConfig,
    spec: LayerSpec,
    p: dict[str, Any],
    x: Tensor,
    positions: Tensor,
    *,
    cache: dict[str, Tensor] | None = None,
    cache_index: int | None = None,
    kv_chunk: int = 1024,
    mamba_chunk: int = 256,
    ssm_impl: str = "scan",
    attn_impl: str = "chunked",
    mamba_scan_dtype: torch.dtype | None = None,
    with_aux: bool = False,
    ctx=None,
) -> tuple[Tensor, dict[str, Tensor] | None, Tensor | None]:
    """Apply one block.  Returns (x, the layer's cache or None, the MoE
    aux loss: a 0-d f32 tensor for an MoE layer with ``with_aux``, else
    None)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if spec.mixer == "attn":
        out, new_cache = attn_apply(
            p["attn"], h, positions,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            d_head=cfg.head_dim, causal=cfg.causal, window=spec.window,
            score_cap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
            mrope_sections=cfg.mrope_sections, cache=cache,
            cache_index=cache_index, kv_chunk=kv_chunk,
            impl=attn_impl if x.shape[1] > 1 else "chunked", ctx=ctx,
        )
    else:
        out, new_cache = mamba_apply(
            p["mamba"], h, d_state=cfg.ssm_state, conv_width=cfg.conv_width,
            chunk=mamba_chunk, cache=cache,
            impl=ssm_impl if x.shape[1] > 1 else "scan",
            scan_dtype=mamba_scan_dtype or torch.float32, ctx=ctx,
        )
    x = x + out
    aux = None
    if spec.moe:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        out, aux = moe_apply(p["moe"], h, top_k=cfg.top_k,
                             n_real=cfg.n_experts, act=cfg.act,
                             with_aux=with_aux,
                             mesh=None if ctx is None else ctx.mesh,
                             dp_axes=("data",) if ctx is None else ctx.dp,
                             ctx=ctx)
        x = x + out
    elif cfg.d_ff > 0:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, cfg.act, ctx=ctx)
    if ctx is not None:
        # "sp": with seq-sharded residuals (Megatron-SP) the stream shards
        # over tp; no-op otherwise
        x = ctx.con(x, "dp", "sp", None)
    return x, new_cache, aux


def init_layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     max_len: int, dtype=torch.bfloat16,
                     device=None) -> dict[str, Tensor]:
    """Decode state for one layer (KV cache or SSM state)."""
    if spec.mixer == "attn":
        return init_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                          dtype, device)
    return init_mamba_cache(batch, cfg.d_inner_, cfg.ssm_state,
                            cfg.conv_width, dtype, device)
