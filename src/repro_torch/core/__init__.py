"""The pieces of the JAX package's ``core`` that the port's training needs,
kept as the port's own copies."""
from repro_torch.core.objectstore import NoSuchKey, ObjectStore
