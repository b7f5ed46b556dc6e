"""Sequence-model substrate (port of ``repro.models``): layers,
attention, Mamba, the assembled LM, and the carrier of JAX parameters."""

from repro_torch.models.convert import (lm_caches_from_numpy,
                                        lm_params_from_numpy)
from repro_torch.models.model import LM

__all__ = ["LM", "lm_caches_from_numpy", "lm_params_from_numpy"]
