"""Commit-marked checkpoints on the object store, in the JAX package's layout."""
from repro_torch.checkpoint.manager import MANIFEST, CheckpointManager
