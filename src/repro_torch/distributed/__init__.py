"""Distribution substrate (port of ``repro.distributed``): gradient
compression.  Sharding rules and elasticity are not ported yet (ROADMAP
Queue 1, distributed LM and launch)."""

from repro_torch.distributed.compression import CompressionConfig, compress_grads

__all__ = ["CompressionConfig", "compress_grads"]
