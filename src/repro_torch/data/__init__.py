"""Token data for the training path (numpy; the reference's pipeline)."""
from .pipeline import SyntheticLMDataset, TokenFileDataset, Prefetcher  # noqa: F401
