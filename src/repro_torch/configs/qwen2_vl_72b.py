"""qwen2-vl-72b [vlm] — 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064,
M-RoPE (t/h/w 16/24/24), dynamic resolution.  The vision patch frontend is a
STUB: input_specs() provides precomputed patch embeddings for the vision
prefix plus (B, 3, S) M-RoPE position streams.  [arXiv:2409.12191; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    mrope_sections=(16, 24, 24),
    vision_prefix=1024,
    rope_theta=1_000_000.0,
    qkv_bias=True,
)
