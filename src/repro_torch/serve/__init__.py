"""Serving substrate: batched autoregressive decode on top of LM caches."""

from repro_torch.serve.decode import DecodeSession, greedy_decode

__all__ = ["DecodeSession", "greedy_decode"]
