"""Configs: the ten architectures and the input shapes, + the paper's
search config (``configs.paper_dtw``); copies of ``repro.configs``, data
only."""

from repro_torch.configs.base import SHAPES, ArchConfig, LayerSpec, ShapeConfig
from repro_torch.configs.registry import ARCHS, get_arch, reduced

__all__ = ["ARCHS", "SHAPES", "ArchConfig", "LayerSpec", "ShapeConfig",
           "get_arch", "reduced"]
