"""Top-level language/sequence model: a stack of blocks + heads (port of
``repro.models.model``).

``LM`` keeps the JAX package's interface: parameters are an explicit
nested dict (f32 at rest) passed to ``loss_fn``, ``prefill`` and
``decode_step``, and ``compute_params`` makes the compute-dtype copy of
every >=2-D parameter.  The stack is a plain loop over layers
(``params["layers"][i]``, one dict per layer; ``models.convert``
unstacks the JAX package's scanned layout into it) with no scan or mesh;
with ``remat`` (the default, as in JAX) each layer of a forward without
caches runs under ``torch.utils.checkpoint`` when autograd records it, so
the backward recomputes it instead of keeping its activations.
``attn_impl="kernel"`` and ``ssm_impl="kernel"`` (JAX's ``"pallas"``)
route through the K9 and K10 ops, differentiable through their autograd
Functions; ``"chunked"`` and ``"scan"`` run the plain versions.

Configurations with layers this slice does not have raise
``NotImplementedError`` naming the ROADMAP item (MoE, M-RoPE/vision
prefix, audio ``frames`` inputs); nothing falls back.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.blocks import init_layer_cache, layer_apply, layer_init
from repro_torch.models.layers import (
    chunked_cross_entropy,
    embed_init,
    embed_lookup,
    lecun_normal,
    rms_norm,
    softcap,
)

Tensor = torch.Tensor


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a configuration with layers this slice does not port."""
    if any(cfg.layer_spec(i).moe for i in range(cfg.n_layers)):
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP Queue 1 "
            "item 2)")
    if cfg.mrope_sections is not None or cfg.vision_prefix:
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE and vision-prefix inputs are not ported "
            "yet (ROADMAP Queue 1 item 3)")
    if not cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name}: audio frame inputs are not ported yet (ROADMAP "
            "Queue 1 item 3)")


def _cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    if tree.dim() >= 2 and tree.dtype == torch.float32:
        return tree.to(dtype)
    return tree


class LM(nn.Module):
    """One model configuration with its numeric and routing options.

    It holds no weights: ``init`` returns the parameter dict and every
    call takes it, as in the JAX package."""

    def __init__(self, cfg: ArchConfig, *, compute_dtype=torch.bfloat16,
                 cache_dtype=torch.bfloat16, kv_chunk: int = 1024,
                 mamba_chunk: int = 256, attn_impl: str = "chunked",
                 ssm_impl: str = "scan", remat: bool = True,
                 ce_chunk: int = 512):
        super().__init__()
        check_supported(cfg)
        if attn_impl not in ("chunked", "kernel"):
            raise ValueError(f"attn_impl {attn_impl!r}: 'chunked' or "
                             "'kernel'")
        if ssm_impl not in ("scan", "kernel"):
            raise ValueError(f"ssm_impl {ssm_impl!r}: 'scan' or 'kernel'")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.cache_dtype = cache_dtype
        self.kv_chunk = kv_chunk
        self.mamba_chunk = mamba_chunk
        self.attn_impl = attn_impl
        self.ssm_impl = ssm_impl
        self.remat = remat
        self.ce_chunk = ce_chunk

    def compute_params(self, params: dict[str, Any]) -> dict[str, Any]:
        """The compute-dtype copy of every >=2-D f32 parameter (1-D norm
        scales and biases stay f32).  A tree already cast comes back
        without a copy, so a session casts once and passes the result."""
        return _cast_tree(params, self.compute_dtype)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator | None = None,
             device=None) -> dict[str, Any]:
        """Random f32 parameters drawn from ``generator`` on ``device``
        (default: the generator's device, else CUDA)."""
        if device is None and generator is not None:
            device = generator.device
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        cfg = self.cfg
        params: dict[str, Any] = {
            "final_norm": torch.zeros(cfg.d_model, device=dev),
            "embed": embed_init(generator, dev, cfg.vocab, cfg.d_model),
            "layers": [layer_init(generator, dev, cfg, cfg.layer_spec(i))
                       for i in range(cfg.n_layers)],
        }
        if not cfg.tie_embeddings:
            params["head"] = lecun_normal((cfg.d_model, cfg.vocab), generator,
                                          dev)
        return params

    # ------------------------------------------------------------------
    def backbone(self, params: dict[str, Any], x: Tensor, positions: Tensor,
                 caches: list | None = None,
                 cache_index: int | None = None) -> tuple[Tensor, list | None]:
        cfg = self.cfg
        remat = self.remat and caches is None and torch.is_grad_enabled()
        for i, p in enumerate(params["layers"]):
            def apply(x, p, i=i):
                return layer_apply(
                    cfg, cfg.layer_spec(i), p, x, positions,
                    cache=caches[i] if caches is not None else None,
                    cache_index=cache_index, kv_chunk=self.kv_chunk,
                    mamba_chunk=self.mamba_chunk, ssm_impl=self.ssm_impl,
                    attn_impl=self.attn_impl)[0]
            x = (checkpoint(apply, x, p, use_reentrant=False) if remat
                 else apply(x, p))
        return x, caches

    def embed(self, params: dict[str, Any], batch: dict[str, Any]) -> Tensor:
        table = params["embed"]
        tokens = torch.as_tensor(batch["tokens"], device=table.device)
        return embed_lookup(table, tokens, self.compute_dtype)

    def head(self, params: dict[str, Any]) -> Tensor:
        if "head" in params:
            return params["head"]
        return params["embed"].T

    def _logits(self, params: dict[str, Any], hidden: Tensor) -> Tensor:
        hidden = rms_norm(hidden, params["final_norm"], self.cfg.norm_eps)
        logits = (hidden @ self.head(params).to(hidden.dtype)).float()
        return softcap(logits[:, 0, :], self.cfg.final_softcap)

    # ------------------------------------------------------------------
    def loss_fn(self, params: dict[str, Any],
                batch: dict[str, Any]) -> tuple[Tensor, dict[str, Tensor]]:
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (both ``(B, S)``; labels below 0 are masked),
        with gradients: ``(loss, {"ce", "aux"})``.  ``aux`` is 0 (the
        port has no MoE), so the loss is the CE."""
        cfg = self.cfg
        params = self.compute_params(params)
        x = self.embed(params, batch)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        hidden, _ = self.backbone(params, x, positions)
        hidden = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
        labels = torch.as_tensor(batch["labels"], device=x.device)
        ce = chunked_cross_entropy(
            hidden, self.head(params), torch.clamp(labels, min=0),
            chunk=self.ce_chunk, final_softcap_val=cfg.final_softcap,
            mask=labels >= 0)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    @torch.no_grad()
    def prefill(self, params: dict[str, Any], batch: dict[str, Any],
                max_len: int | None = None) -> tuple[Tensor, list, int]:
        """Forward + KV/SSM-state fill.  Returns (last-token logits (B, V)
        f32, caches, next cache index).  ``max_len`` sizes the cache for
        continued decoding (default: the prompt length, a full-cache
        prefill, whose attention runs K9 under ``attn_impl="kernel"``)."""
        params = self.compute_params(params)
        x = self.embed(params, batch)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        caches = self.init_caches(B, max_len or S, x.device)
        hidden, caches = self.backbone(params, x, positions, caches, 0)
        return self._logits(params, hidden[:, -1:, :]), caches, S

    @torch.no_grad()
    def decode_step(self, params: dict[str, Any], caches: list,
                    tokens: Tensor, cache_index: int) -> tuple[Tensor, list]:
        """One autoregressive step of (B, 1) tokens against filled caches,
        written at ``cache_index``.  Returns (logits (B, V), caches)."""
        params = self.compute_params(params)
        x = self.embed(params, {"tokens": tokens})
        B = x.shape[0]
        pos = torch.full((B, 1), cache_index, dtype=torch.long,
                         device=x.device)
        hidden, caches = self.backbone(params, x, pos, caches, cache_index)
        return self._logits(params, hidden), caches

    forward = prefill

    def init_caches(self, batch: int, max_len: int, device=None) -> list:
        """One decode-state dict per layer."""
        cfg = self.cfg
        return [init_layer_cache(cfg, cfg.layer_spec(i), batch, max_len,
                                 self.cache_dtype, device)
                for i in range(cfg.n_layers)]
