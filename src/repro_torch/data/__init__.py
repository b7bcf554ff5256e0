"""Data substrate."""

from .pipeline import SyntheticLMDataset, make_train_iterator  # noqa: F401
