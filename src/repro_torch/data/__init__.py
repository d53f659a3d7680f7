"""Deterministic synthetic token batches (numpy only)."""
from repro_torch.data.pipeline import (DataConfig, SyntheticDataset, dataset_for,
                                       with_frontend_stubs)
