"""Parallelism helpers (port of ``repro.parallel``): the mesh the steps
install while they run (``ep``).  The expert-parallel MoE routes and the
pipeline wait for ROADMAP.md Queue 1 item 5b."""
from repro_torch.parallel.ep import current_mesh, ep_mesh
