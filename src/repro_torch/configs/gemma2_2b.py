"""gemma2-2b [dense] — 26L d=2304 8H (GQA kv=4) d_ff=9216 vocab=256000,
local(4k)+global alternating attention, logit softcaps.  [arXiv:2408.00118; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab=256000,
    d_head=256,
    sliding_window=4096,
    local_global_period=2,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    tie_embeddings=True,
)
