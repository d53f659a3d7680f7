"""The hardware model of the roofline analysis (port of
``repro.launch.mesh::HW``), for one NVIDIA H100 SXM 80 GB.

The reference's mesh constructors (``make_production_mesh``,
``make_local_mesh``) wait for distribution (ROADMAP.md Queue 1 item 5): the
port runs on one device.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, per card.  ``nvlink_bw`` (NVLink 4, 900 GB/s
# both ways) stands where the reference's ``ici_bw`` does; no collective
# runs on one card yet.
HW = {
    "peak_flops_bf16": 989e12,   # FLOP/s, dense bf16 on the tensor cores
    "hbm_bw": 3.35e12,           # B/s
    "nvlink_bw": 450e9,          # B/s per direction
    "hbm_bytes": 80 * 1024**3,   # capacity
}
