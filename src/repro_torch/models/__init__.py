"""Sequence-model substrate (port of ``repro.models``): layers,
attention, Mamba, the assembled LM, and the carriers of JAX parameters,
caches and train states."""

from repro_torch.models.convert import (lm_caches_from_numpy,
                                        lm_params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.models.model import LM

__all__ = ["LM", "lm_caches_from_numpy", "lm_params_from_numpy",
           "train_state_from_numpy"]
