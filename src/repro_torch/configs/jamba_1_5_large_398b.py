"""jamba-1.5-large-398b [hybrid] — 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, Mamba+attention 1:7 interleave, MoE 16e top-2 on every other
layer.  [arXiv:2403.19887; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    attn_every=8,          # one attention layer per 8 (1:7 with mamba)
    attn_offset=4,
    d_inner=16384,
    ssm_state=16,
    n_experts=16,
    n_shared_experts=0,
    top_k=2,
    d_expert=24576,
    moe_period=2,          # MoE every other layer
)
