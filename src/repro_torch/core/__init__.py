"""The port's own copies of the JAX package's ``core`` pieces that a
resource manager runs: the object store (checkpoints), the server side of
the REST transport (``rest``) and the ``jaxlocal`` resource manager with its
simulated cluster and slurm dialect (``backends``).  The Bridge itself (the
operator, controllers, adapters and clients) stays in ``repro.core``."""
from repro_torch.core.objectstore import NoSuchKey, ObjectStore
