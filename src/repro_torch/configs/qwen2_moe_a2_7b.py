"""qwen2-moe-a2.7b [moe] — 24L d=2048 16H (GQA kv=16) d_ff=1408 vocab=151936,
MoE 60 routed top-4 + 4 shared experts.  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    d_expert=1408,
    rope_theta=1_000_000.0,
)
