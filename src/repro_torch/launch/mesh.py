"""The local device mesh (port of ``repro.launch.mesh::make_local_mesh``)
and the hardware model of the roofline analysis (``HW``), for one NVIDIA
H100 SXM 80 GB.

``make_local_mesh`` is a function, so importing this module touches no
process group or device.  ``make_production_mesh`` (16 x 16 and 2 x 16 x 16)
waits for ROADMAP.md Queue 1 item 5a-iv; the sharding rules take its layout
as a plain ``{name: size}`` dict meanwhile (``repro_torch.sharding``).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, per card.  ``nvlink_bw`` (NVLink 4, 900 GB/s
# both ways) stands where the reference's ``ici_bw`` does.
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s, dense bf16 on the tensor cores
    "hbm_bw": 3.35e12,           # B/s
    "nvlink_bw": 450e9,          # B/s per direction
    "hbm_bytes": 80 * 1024**3,   # capacity
}


def make_local_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """A ``(data, model)`` ``DeviceMesh`` with axes ("data", "model") over the
    ranks of the process group that is up: NCCL on the cards by default,
    gloo with ``device="cpu"``.  Raises unless a group of exactly
    ``data * model`` ranks is up; it starts none itself."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"make_local_mesh({data}, {model}): no process group is up; "
                           "call torch.distributed.init_process_group first")
    if dist.get_world_size() != data * model:
        raise RuntimeError(f"make_local_mesh({data}, {model}) needs {data * model} ranks, "
                           f"the process group has {dist.get_world_size()}")
    if device == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError(f"a cuda mesh needs the nccl backend, not {dist.get_backend()!r}; "
                           "pass device='cpu' for gloo")
    return init_device_mesh(device, (data, model), mesh_dim_names=("data", "model"))
