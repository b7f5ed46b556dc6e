"""Architecture + shape configuration system (a copy of
``repro.configs.base``: the port keeps its own, as it imports nothing of
the JAX package).

Every assigned architecture is an ``ArchConfig``; the four assigned input
shapes are ``ShapeConfig``s.  ``cells()`` enumerates the (arch x shape)
dry-run grid with per-cell applicability (encoder archs have no decode;
``long_500k`` requires sub-quadratic context handling — DESIGN.md SS5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Static per-layer structure (drives the scanned block body)."""

    mixer: str = "attn"          # "attn" | "mamba"
    window: int | None = None    # sliding-window size for local attention
    moe: bool = False            # routed-MoE FFN (else dense MLP)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None

    # attention features
    causal: bool = True
    qkv_bias: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    sliding_window: int | None = None     # used by local layers
    local_global_period: int = 0          # 2 -> alternate local/global
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] | None = None

    # input modality
    embed_inputs: bool = True             # False: frontend stub provides embeddings
    vision_prefix: int = 0                # VLM: patch-embedding positions

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int | None = None
    moe_period: int = 1                   # MoE every k-th layer
    first_dense: int = 0                  # leading dense layers (deepseek)

    # SSM / hybrid
    attn_every: int = 0                   # 0: all attn; -1: all mamba; k: attn at i%k==offset
    attn_offset: int = 4
    d_inner: int | None = None
    ssm_state: int = 16
    conv_width: int = 4
    dt_rank: int | None = None

    act: str = "silu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank if self.dt_rank else max(1, self.d_model // 16)

    @property
    def d_inner_(self) -> int:
        return self.d_inner if self.d_inner else 2 * self.d_model

    def layer_spec(self, i: int) -> LayerSpec:
        if self.attn_every == -1:
            mixer = "mamba"
        elif self.attn_every > 0:
            mixer = "attn" if i % self.attn_every == self.attn_offset else "mamba"
        else:
            mixer = "attn"
        window = None
        if mixer == "attn" and self.sliding_window:
            if self.local_global_period:
                if i % self.local_global_period == 0:   # local first (gemma2)
                    window = self.sliding_window
            else:
                window = self.sliding_window
        moe = (
            self.n_experts > 0
            and i >= self.first_dense
            and (i % self.moe_period == (self.moe_period - 1) if self.moe_period > 1 else True)
        )
        return LayerSpec(mixer=mixer, window=window, moe=moe)

    def layout(self) -> tuple[list[LayerSpec], list[LayerSpec], int]:
        """(prelude specs, period specs, n_repeat) for the scanned stack."""
        specs = [self.layer_spec(i) for i in range(self.n_layers)]
        prelude = specs[: self.first_dense]
        rest = specs[self.first_dense :]
        # find the smallest period that tiles the remaining layers
        for period in (1, 2, 4, 8):
            if len(rest) % period:
                continue
            pat = rest[:period]
            if all(
                rest[j] == pat[j % period] for j in range(len(rest))
            ):
                return prelude, pat, len(rest) // period
        raise ValueError(f"{self.name}: no periodic layout found")

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND."""
        d, dh = self.d_model, self.head_dim
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            spec = self.layer_spec(i)
            if spec.mixer == "attn":
                total += d * dh * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * dh * d
            else:
                din, n, r = self.d_inner_, self.ssm_state, self.dt_rank_
                total += d * 2 * din + din * (r + 2 * n) + r * din
                total += din * (n + 1 + self.conv_width) + din * d
            if spec.moe:
                fe = self.d_expert or self.d_ff
                total += d * self.n_experts_padded
                total += self.n_experts * 3 * d * fe
                total += self.n_shared_experts * 3 * d * fe
            else:
                mult = 3 if self.act == "silu" else 2
                total += mult * d * self.d_ff
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE top-k instead of all experts)."""
        if self.n_experts == 0:
            return self.n_params()
        d = self.d_model
        fe = self.d_expert or self.d_ff
        inactive = 0
        for i in range(self.n_layers):
            if self.layer_spec(i).moe:
                inactive += (self.n_experts - self.top_k) * 3 * d * fe
        return self.n_params() - inactive

    @property
    def n_experts_padded(self) -> int:
        """Experts padded to a multiple of 16 for clean EP sharding."""
        return int(math.ceil(self.n_experts / 16) * 16) if self.n_experts else 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str   # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicability(arch: ArchConfig, shape: ShapeConfig) -> str | None:
    """None if the cell runs; otherwise the documented skip reason."""
    if shape.kind == "decode" and not arch.causal:
        return "encoder-only architecture: no autoregressive decode step"
    if shape.name == "long_500k":
        sub_quadratic = (
            arch.attn_every != 0          # ssm / hybrid
            or arch.sliding_window is not None   # local(+global) attention
        )
        if not sub_quadratic:
            return "pure full-attention arch: 512k decode KV excluded (DESIGN.md SS5)"
    return None


def cells(arch: ArchConfig) -> Iterable[tuple[ShapeConfig, str | None]]:
    for s in SHAPES.values():
        yield s, shape_applicability(arch, s)
