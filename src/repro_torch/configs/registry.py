"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs
(a copy of ``repro.configs.registry``; the ten config modules beside it are
copies of the JAX package's, data only)."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    deepseek_moe_16b,
    falcon_mamba_7b,
    gemma2_2b,
    granite_8b,
    granite_20b,
    hubert_xlarge,
    jamba_1_5_large_398b,
    qwen2_5_3b,
    qwen2_moe_a2_7b,
    qwen2_vl_72b,
)
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, cells

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen2_moe_a2_7b,
        deepseek_moe_16b,
        granite_20b,
        gemma2_2b,
        qwen2_5_3b,
        granite_8b,
        hubert_xlarge,
        falcon_mamba_7b,
        jamba_1_5_large_398b,
        qwen2_vl_72b,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Shrink a config to smoke-test size while preserving its *structure*
    (same family, same layer pattern, same divisibility properties)."""
    prelude, period, _ = cfg.layout()
    n_layers = cfg.first_dense + 2 * len(period)     # two periods
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_head=16,
        d_ff=cfg.d_ff and 128,
        vocab=256,
        d_expert=32 if cfg.d_expert else None,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_inner=128 if cfg.d_inner else None,
        dt_rank=8,
        sliding_window=8 if cfg.sliding_window else None,
        vision_prefix=4 if cfg.vision_prefix else 0,
        mrope_sections=(2, 3, 3) if cfg.mrope_sections else None,
    )


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeConfig", "cells", "get_arch", "reduced"]
