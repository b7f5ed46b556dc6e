"""Data substrate: synthetic UCR-like series + LM token pipeline."""

from repro_torch.data.synthetic import Dataset, make_dataset, random_pairs
from repro_torch.data.tokens import TokenPipeline

__all__ = ["Dataset", "TokenPipeline", "make_dataset", "random_pairs"]
