from repro_torch.data.synthetic import Dataset, make_dataset, random_pairs

__all__ = ["Dataset", "make_dataset", "random_pairs"]
