"""Sequence-model substrate (port of ``repro.models``): layers (with
M-RoPE), attention, Mamba, MoE, the assembled LM, and the carriers of JAX
parameters, caches and train states."""

from repro_torch.models.convert import (lm_caches_from_numpy,
                                        lm_params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.models.layers import apply_mrope
from repro_torch.models.model import LM
from repro_torch.models.moe import moe_apply, moe_init

__all__ = ["LM", "apply_mrope", "lm_caches_from_numpy",
           "lm_params_from_numpy", "moe_apply", "moe_init",
           "train_state_from_numpy"]
