"""Parallelism helpers (port of ``repro.parallel``): the mesh the steps
install while they run and the expert-parallel MoE routes (``ep``), and the
GPipe loop over a mesh axis (``pipeline``)."""
from repro_torch.parallel.ep import current_mesh, ep_mesh, moe_ep_gather, moe_ep_shard_map
from repro_torch.parallel.pipeline import pipeline_apply, stack_stage_params
