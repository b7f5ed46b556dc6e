from repro_torch.data.synthetic import Dataset, make_dataset

__all__ = ["Dataset", "make_dataset"]
