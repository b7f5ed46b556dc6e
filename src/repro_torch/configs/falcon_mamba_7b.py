"""falcon-mamba-7b [ssm] — 64L d=4096, attention-free Mamba-1,
d_inner=8192 ssm_state=16, vocab=65024.  [arXiv:2410.05355]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,               # no separate FFN: mamba block is the layer
    vocab=65024,
    attn_every=-1,
    d_inner=8192,
    ssm_state=16,
    conv_width=4,
)
