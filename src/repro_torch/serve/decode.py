"""Batched autoregressive decoding on top of the LM caches (port of
``repro.serve.decode``).

``DecodeSession`` runs eagerly on the device its parameters live on.  It
makes the compute-dtype copy of the parameters once, when it is created,
and passes that copy to every prefill and step (JAX casts inside each
jitted call instead; the numbers are the same).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.model import LM

Tensor = torch.Tensor


class DecodeSession:
    """Prefill once, then step token by token against the filled caches."""

    def __init__(self, model: LM, params: dict[str, Any], max_len: int):
        self.model = model
        self.max_len = max_len
        self.params = model.compute_params(params)
        self.device = self.params["final_norm"].device
        self.caches = None
        self.index = None

    def prefill(self, batch: dict[str, Any]) -> Tensor:
        logits, self.caches, self.index = self.model.prefill(
            self.params, batch, max_len=self.max_len)
        return logits

    def step(self, tokens: Tensor) -> Tensor:
        """Feed (B, 1) tokens; returns (B, V) next-token logits."""
        logits, self.caches = self.model.decode_step(
            self.params, self.caches, tokens, self.index)
        self.index += 1
        return logits


def greedy_decode(model: LM, params: dict[str, Any], prompt,
                  n_steps: int) -> Tensor:
    """Greedy continuation of ``prompt`` (B, S) for ``n_steps`` tokens,
    ``(B, n_steps)`` int32."""
    sess = DecodeSession(model, params, max_len=prompt.shape[1] + n_steps)
    prompt = torch.as_tensor(prompt, device=sess.device)
    logits = sess.prefill({"tokens": prompt})
    toks = [torch.argmax(logits, -1)[:, None].to(torch.int32)]
    for _ in range(n_steps - 1):
        logits = sess.step(toks[-1])
        toks.append(torch.argmax(logits, -1)[:, None].to(torch.int32))
    return torch.cat(toks, dim=1)
