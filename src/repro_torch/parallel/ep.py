"""The mesh a step installs while it runs (port of ``repro.parallel.ep``'s
``ep_mesh`` and ``current_mesh``).

The step builders install their mesh with ``ep_mesh(mesh)``; the model
code finds it with ``current_mesh()`` (``attention_partitioning="seq"`` in
``models/layers.py``).  The reference's expert-parallel MoE routes, which
read it too, wait for ROADMAP.md Queue 1 item 5b.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional

_state = threading.local()


@contextlib.contextmanager
def ep_mesh(mesh: Any):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def current_mesh() -> Optional[Any]:
    return getattr(_state, "mesh", None)
