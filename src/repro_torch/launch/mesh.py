"""The device meshes (port of ``repro.launch.mesh``: ``make_local_mesh``
and ``make_production_mesh``) and the hardware model of the roofline
analysis (``HW``), for one NVIDIA H100 SXM 80 GB.

Both meshes are made by functions over a process group that is already up,
so importing this module touches no process group or device.  The
production mesh (16 x 16, or 2 x 16 x 16 with ``multi_pod``) is what the
dry-run counts on (``launch/dryrun.py``, over a ``"fake"`` group of 256 or
512 ranks in one process); the sharding rules also take its layout as a
plain ``{name: size}`` dict (``repro_torch.sharding``).
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


def _mesh(what: str, shape, names, device: str):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the process group
    that is up; raises unless it has exactly the mesh's ranks (and NCCL for
    a cuda mesh).  Starts no group itself."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{what}: no process group is up; "
                           "call torch.distributed.init_process_group first")
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(f"{what} needs {math.prod(shape)} ranks, "
                           f"the process group has {dist.get_world_size()}")
    if device == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError(f"a cuda mesh needs the nccl backend, not {dist.get_backend()!r}; "
                           "pass device='cpu' for gloo")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(names))


def make_local_mesh(data: int = 1, model: int = 1, device: str = "cuda"):
    """A ``(data, model)`` ``DeviceMesh`` with axes ("data", "model") over the
    ranks of the process group that is up: NCCL on the cards by default,
    gloo with ``device="cpu"``.  Raises unless a group of exactly
    ``data * model`` ranks is up; it starts none itself."""
    return _mesh(f"make_local_mesh({data}, {model})", (data, model), ("data", "model"), device)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The reference's production mesh: (16, 16) with axes ("data",
    "model"), or with ``multi_pod`` (2, 16, 16) with axes ("pod", "data",
    "model"), over the ranks of the process group that is up (NCCL for
    ``device="cuda"``; the dry-run's ``"fake"`` group with ``device="cpu"``).
    Raises unless a group of exactly 256 (512) ranks is up; it starts none
    itself."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(f"make_production_mesh(multi_pod={multi_pod})", shape, names, device)
