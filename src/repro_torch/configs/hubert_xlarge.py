"""hubert-xlarge [audio] — 48L d=1280 16H d_ff=5120 vocab=504, encoder-only
(w2v2-style backbone).  The conv waveform frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, S, d); the head predicts the 504
k-means target units per frame.  [arXiv:2106.07447]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    causal=False,          # encoder-only
    embed_inputs=False,    # frontend stub provides frame embeddings
    act="gelu",
)
