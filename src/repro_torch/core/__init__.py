"""Plain PyTorch DTW, envelopes and lower bounds (``repro.core``'s port)."""
