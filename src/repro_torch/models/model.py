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
Functions; ``"chunked"`` and ``"scan"`` run the plain versions, and
``"bypass"`` the dry-run's stand-ins for the kernels (``launch.dryrun``;
they compute no attention and no recurrence).  ``mamba_scan_dtype``
(default f32) is the plain scan's prefix-scan dtype, JAX's
``mamba_scan_dtype``.

Inputs, as in the JAX package: ``tokens`` (B, S); for an encoder over
frames (``embed_inputs=False``, hubert) ``frames`` (B, S, d), normed by
``in_norm``; for a VLM, ``vision_embeds`` (B, P, d) overwrite the first P
token embeddings and ``positions`` (B, 3, S) carry M-RoPE's streams.  The
MoE layers' aux losses sum over the stack into ``loss_fn``'s loss.

Under a mesh (``LM(cfg, mesh=...)``, JAX ``model.py:32-53``) the model
is SPMD over a ``DeviceMesh``, one process a rank: the parameters are
DTensors placed by ``distributed.sharding.param_shardings``, the inputs
(the whole batch on every rank, or DTensors) are split over the data
axes, activations are DTensors constrained by ``LM.ctx`` as in JAX, the
caches are placed by ``cache_shardings``, and K9, K10 and the MoE
experts run on each rank's local shards.  With ``mesh=None`` every path
computes what it computes without this option.
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


def _cast_leaf(t: Tensor, dtype: torch.dtype) -> Tensor:
    if t.dim() >= 2 and t.dtype == torch.float32:
        return t.to(dtype)
    return t


def _cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return _cast_leaf(tree, dtype)


def _cast_tree_(tree: dict[str, Any], dtype: torch.dtype) -> dict[str, Any]:
    """``_cast_tree`` in place, a leaf at a time: each f32 leaf is freed
    as its cast replaces it, so the tree's f32 and cast copies are never
    whole together."""
    for k, v in tree.items():
        tree[k] = (_cast_tree_(v, dtype) if isinstance(v, dict)
                   else _cast_leaf(v, dtype))
    return tree


class LM(nn.Module):
    """One model configuration with its numeric and routing options.

    It holds no weights: ``init`` returns the parameter dict and every
    call takes it, as in the JAX package."""

    def __init__(self, cfg: ArchConfig, *, compute_dtype=torch.bfloat16,
                 cache_dtype=torch.bfloat16, kv_chunk: int = 1024,
                 mamba_chunk: int = 256, attn_impl: str = "chunked",
                 ssm_impl: str = "scan", remat: bool = True,
                 ce_chunk: int = 512, mesh=None,
                 dp_axes: tuple[str, ...] = ("data",),
                 seq_shard: bool = False,
                 mamba_scan_dtype: torch.dtype | None = None):
        super().__init__()
        if attn_impl not in ("chunked", "kernel", "bypass"):
            raise ValueError(f"attn_impl {attn_impl!r}: 'chunked', "
                             "'kernel' or 'bypass'")
        if ssm_impl not in ("scan", "kernel", "bypass"):
            raise ValueError(f"ssm_impl {ssm_impl!r}: 'scan', 'kernel' or "
                             "'bypass'")
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.cache_dtype = cache_dtype
        self.kv_chunk = kv_chunk
        self.mamba_chunk = mamba_chunk
        self.attn_impl = attn_impl
        self.ssm_impl = ssm_impl
        self.remat = remat
        self.ce_chunk = ce_chunk
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes)
        self.seq_shard = seq_shard
        self.mamba_scan_dtype = mamba_scan_dtype

    @property
    def ctx(self):
        """The activation-constraint helper, or None without a mesh."""
        if self.mesh is None:
            return None
        from repro_torch.distributed.sharding import ShardCtx

        return ShardCtx(mesh=self.mesh, dp=self.dp_axes, tp="model",
                        seq_shard=self.seq_shard)

    def _input(self, x, *roles):
        """A batch input or activation, constrained to ``roles`` under a
        mesh (split over the data axes)."""
        ctx = self.ctx
        return x if ctx is None else ctx.con(x, *roles)

    def compute_params(self, params: dict[str, Any]) -> dict[str, Any]:
        """The compute-dtype copy of every >=2-D f32 parameter (1-D norm
        scales and biases stay f32).  A tree already cast comes back
        without a copy, so a session casts once and passes the result."""
        return _cast_tree(params, self.compute_dtype)

    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator | None = None,
             device=None, dtype: torch.dtype | None = None
             ) -> dict[str, Any]:
        """Random f32 parameters drawn from ``generator`` on ``device``
        (default: the generator's device, else CUDA); on ``"meta"`` nothing
        is drawn, and the tensors have the same shapes and dtypes.  With
        ``dtype``, the same draws come back as ``compute_params`` in
        ``dtype`` would make them, each part cast as soon as it is drawn:
        the f32 tree is never whole, so a model whose f32 weights and
        compute copy do not fit the device together can still be
        served."""
        if device is None and generator is not None:
            device = generator.device
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)

        def part(x):
            if dtype is None:
                return x
            return (_cast_tree_(x, dtype) if isinstance(x, dict)
                    else _cast_leaf(x, dtype))

        cfg = self.cfg
        params: dict[str, Any] = {
            "final_norm": torch.zeros(cfg.d_model, device=dev)}
        if cfg.embed_inputs:
            params["embed"] = part(embed_init(generator, dev, cfg.vocab,
                                              cfg.d_model))
        else:
            params["in_norm"] = torch.zeros(cfg.d_model, device=dev)
        params["layers"] = [
            part(layer_init(generator, dev, cfg, cfg.layer_spec(i)))
            for i in range(cfg.n_layers)]
        if not cfg.tie_embeddings or not cfg.embed_inputs:
            params["head"] = part(lecun_normal((cfg.d_model, cfg.vocab),
                                               generator, dev))
        return params

    # ------------------------------------------------------------------
    def backbone(self, params: dict[str, Any], x: Tensor, positions: Tensor,
                 caches: list | None = None, cache_index: int | None = None,
                 with_aux: bool = False) -> tuple[Tensor, list | None, Any]:
        """The layer stack: (hidden, caches, the MoE layers' summed aux
        loss, a 0-d f32 tensor, with ``with_aux``; else None, and no MoE
        layer computes it)."""
        cfg = self.cfg
        ctx = self.ctx
        remat = self.remat and caches is None and torch.is_grad_enabled()
        aux_total = (torch.zeros((), dtype=torch.float32, device=x.device)
                     if with_aux else None)
        for i, p in enumerate(params["layers"]):
            def apply(x, p, i=i):
                x, nc, aux = layer_apply(
                    cfg, cfg.layer_spec(i), p, x, positions,
                    cache=caches[i] if caches is not None else None,
                    cache_index=cache_index, kv_chunk=self.kv_chunk,
                    mamba_chunk=self.mamba_chunk, ssm_impl=self.ssm_impl,
                    attn_impl=self.attn_impl,
                    mamba_scan_dtype=self.mamba_scan_dtype,
                    with_aux=with_aux, ctx=ctx)
                if caches is not None:
                    caches[i] = nc
                return x, aux
            x, aux = (checkpoint(apply, x, p, use_reentrant=False) if remat
                      else apply(x, p))
            if aux is not None:
                aux_total = aux_total + aux
        return x, caches, aux_total

    def embed(self, params: dict[str, Any], batch: dict[str, Any]) -> Tensor:
        """Input activations in the compute dtype: frames normed by
        ``in_norm`` (``embed_inputs=False``), else token embeddings with a
        VLM's ``vision_embeds`` over the first positions."""
        cfg = self.cfg
        dev = params["final_norm"].device
        dt = self.compute_dtype
        if not cfg.embed_inputs:
            x = self._input(torch.as_tensor(batch["frames"], device=dev),
                            "dp", None, None).to(dt)
            return rms_norm(x, params["in_norm"], cfg.norm_eps)
        tokens = self._input(torch.as_tensor(batch["tokens"], device=dev),
                             "dp", None)
        x = embed_lookup(params["embed"], tokens, dt)
        if cfg.vision_prefix and "vision_embeds" in batch:
            ve = self._input(torch.as_tensor(batch["vision_embeds"],
                                             device=dev),
                             "dp", None, None).to(dt)
            x = torch.cat([ve, x[:, ve.shape[1]:]], dim=1)
        return self._input(x, "dp", "sp", None)

    def positions_for(self, batch: dict[str, Any], x: Tensor) -> Tensor:
        """``batch["positions"]`` ((B, 3, S) for M-RoPE) where given, else
        ``arange(S)`` for every row."""
        if "positions" in batch:
            pos = torch.as_tensor(batch["positions"], device=x.device)
            return self._input(pos, "dp", *(None,) * (pos.dim() - 1))
        if self.cfg.mrope_sections is not None:
            raise ValueError(f"{self.cfg.name}: M-RoPE needs "
                             "batch['positions'] of shape (B, 3, S)")
        B, S, _ = x.shape
        return self._input(torch.arange(S, device=x.device).expand(B, S),
                           "dp", None)

    def head(self, params: dict[str, Any]) -> Tensor:
        if "head" in params:
            return params["head"]
        return params["embed"].T

    def _logits(self, params: dict[str, Any], hidden: Tensor) -> Tensor:
        hidden = rms_norm(hidden, params["final_norm"], self.cfg.norm_eps)
        logits = (hidden @ self.head(params).to(hidden.dtype)).float()
        logits = softcap(logits[:, 0, :], self.cfg.final_softcap)
        return self._input(logits, "dp", None)

    # ------------------------------------------------------------------
    def loss_fn(self, params: dict[str, Any],
                batch: dict[str, Any]) -> tuple[Tensor, dict[str, Tensor]]:
        """Mean next-token cross-entropy of the inputs against
        ``batch["labels"]`` ``(B, S)`` (labels below 0 are masked) plus
        0.01 x the MoE layers' aux loss, with gradients: ``(loss, {"ce",
        "aux"})``."""
        cfg = self.cfg
        params = self.compute_params(params)
        x = self.embed(params, batch)
        hidden, _, aux = self.backbone(params, x,
                                       self.positions_for(batch, x),
                                       with_aux=True)
        hidden = rms_norm(hidden, params["final_norm"], cfg.norm_eps)
        labels = self._input(torch.as_tensor(batch["labels"],
                                             device=x.device), "dp", None)
        ce = chunked_cross_entropy(
            hidden, self.head(params), torch.clamp(labels, min=0),
            chunk=self.ce_chunk, final_softcap_val=cfg.final_softcap,
            mask=labels >= 0, ctx=self.ctx)
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
        caches = self.init_caches(B, max_len or S, x.device)
        hidden, caches, _ = self.backbone(
            params, x, self.positions_for(batch, x), caches, 0)
        return self._logits(params, hidden[:, -1:, :]), caches, S

    @torch.no_grad()
    def decode_step(self, params: dict[str, Any], caches: list,
                    tokens: Tensor, cache_index: int) -> tuple[Tensor, list]:
        """One autoregressive step of (B, 1) tokens against filled caches,
        written at ``cache_index`` (every M-RoPE stream at
        ``cache_index``).  Returns (logits (B, V), caches); an encoder over
        frames has no decode step and raises ``ValueError``."""
        cfg = self.cfg
        if not cfg.embed_inputs:
            raise ValueError("encoder-only architectures have no decode step")
        params = self.compute_params(params)
        x = self.embed(params, {"tokens": tokens})
        B = x.shape[0]
        shape = (B, 3, 1) if cfg.mrope_sections is not None else (B, 1)
        pos = self._input(torch.full(shape, cache_index, dtype=torch.long,
                                     device=x.device),
                          "dp", *(None,) * (len(shape) - 1))
        hidden, caches, _ = self.backbone(params, x, pos, caches,
                                          cache_index)
        return self._logits(params, hidden), caches

    forward = prefill

    def init_caches(self, batch: int, max_len: int, device=None) -> list:
        """One decode-state dict per layer; under a mesh each is placed by
        ``cache_shardings`` as soon as it is made, so a rank never holds
        more than one layer's whole cache (JAX's jitted prefill never
        makes them whole)."""
        cfg = self.cfg
        caches = []
        for i in range(cfg.n_layers):
            c = init_layer_cache(cfg, cfg.layer_spec(i), batch, max_len,
                                 self.cache_dtype, device)
            if self.mesh is not None:
                from repro_torch.distributed.sharding import (
                    AxisRules, cache_shardings, shard_tree)

                c = shard_tree(c, cache_shardings(
                    cfg, self.mesh, AxisRules(dp=self.dp_axes), c,
                    batch=batch))
            caches.append(c)
        return caches
