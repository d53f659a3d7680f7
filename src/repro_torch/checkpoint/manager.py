"""Checkpointing: commit-marked, reshard-on-load, async save, keep-last-k,
in the JAX package's layout.

Port of ``repro.checkpoint.manager``.  Layout under an ObjectStore prefix
(a local dir or the in-memory store):

    <prefix>/step_00000123/leaf_00000.npy ... leaf_NNNNN.npy
    <prefix>/step_00000123/MANIFEST.json   <- written LAST (commit marker)

A checkpoint without MANIFEST.json is invisible to ``latest_step``: a save
interrupted by a node failure can never be restored from partially.

Leaves are written in ``tree_leaves`` order (sorted keys), each as a full
array; the manifest lists each leaf's ``path`` (formatted as
``jax.tree_util.keystr`` formats it), ``key``, ``dtype`` and ``shape``.
bf16 leaves are stored as their raw bits (a uint16 array) under the dtype
tag ``"bfloat16"``.  So a checkpoint written by either package restores in
the other, bit for bit.

On a mesh a tree may hold DTensors.  ``save`` gathers each whole
(``full_tensor``, a collective: every rank calls ``save`` and
``save_async``, and the gather runs on the caller's thread, never in the
writer thread); rank 0 writes, and every rank waits on a barrier before
``save`` (or the ``wait`` after ``save_async``) returns, so no rank reads a
half-written step.  Leaves are stored whole, so ``restore`` may place them
on another mesh than the one that saved them (reshard-on-load): with
``shardings``, a tree of ``sharding.P`` matching ``like``, and a ``mesh``,
each rank reads every leaf and keeps its own chunk, so loading moves no
bytes between ranks.
"""
from __future__ import annotations

import io
import json
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import sharding as SH
from repro_torch.core.objectstore import ObjectStore
from repro_torch.models.params import tree_leaves, tree_paths, tree_unflatten

MANIFEST = "MANIFEST.json"


def _dump_npy(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _load_npy(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` (never a view: the train loop updates params in
    place while an async save writes) and its dtype tag."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def _to_tensor(arr: np.ndarray, dtype_tag: str) -> torch.Tensor:
    # np.load over bytes gives a read-only view of them: copy (np.array keeps
    # 0-d arrays 0-d, as np.ascontiguousarray does not)
    arr = np.array(arr)
    if dtype_tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, store: ObjectStore, bucket: str, prefix: str,
                 keep: int = 3):
        self.store = store
        self.bucket = bucket
        self.prefix = prefix.rstrip("/")
        self.keep = keep
        self._async_thread: Optional[threading.Thread] = None
        self._async_err: Optional[BaseException] = None
        self._barrier_due = False

    # -- save ----------------------------------------------------------------

    @staticmethod
    def _to_host(tree: Any) -> Tuple[Optional[List[Tuple[str, np.ndarray, str]]], bool]:
        """((keypath, numpy array [bf16 stored as uint16 view], dtype tag) a
        leaf, whether the tree is on a mesh).  A DTensor leaf is gathered
        whole first; on a mesh only rank 0 keeps host copies (the others get
        None: they write nothing)."""
        on_mesh = any(isinstance(leaf, DTensor) for leaf in tree_leaves(tree))
        out = [] if not on_mesh or torch.distributed.get_rank() == 0 else None
        for path, leaf in tree_paths(tree):
            full = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
            if out is not None:
                out.append((path, *_to_numpy(full)))
        return out, on_mesh

    def _write(self, step: int, host_leaves: List[Tuple[str, np.ndarray, str]],
               extra: Optional[Dict[str, Any]]) -> None:
        stepdir = self._stepdir(step)
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for i, (keypath, arr, dtype_tag) in enumerate(host_leaves):
            key = f"{stepdir}/leaf_{i:05d}.npy"
            self.store.put(self.bucket, key, _dump_npy(arr))
            manifest["leaves"].append({"path": keypath, "key": key,
                                       "dtype": dtype_tag,
                                       "shape": list(arr.shape)})
        # commit marker LAST
        self.store.put(self.bucket, f"{stepdir}/{MANIFEST}",
                       json.dumps(manifest).encode())
        self._gc()

    def save(self, step: int, tree: Any, extra: Optional[Dict[str, Any]] = None) -> None:
        host_leaves, on_mesh = self._to_host(tree)
        if host_leaves is not None:
            self._write(step, host_leaves, extra)
        if on_mesh:
            torch.distributed.barrier()

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot to host memory synchronously, write in the background:
        the train loop resumes while bytes stream out."""
        self.wait()  # one in flight at a time
        host_leaves, self._barrier_due = self._to_host(tree)
        if host_leaves is None:
            return  # a rank that does not write

        def work():
            try:
                self._write(step, host_leaves, extra)
            except BaseException as e:  # surfaced on next wait()
                self._async_err = e

        self._async_thread = threading.Thread(target=work, daemon=True)
        self._async_thread.start()

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._barrier_due:
            self._barrier_due = False
            torch.distributed.barrier()
        if self._async_err is not None:
            err, self._async_err = self._async_err, None
            raise err

    # -- restore ------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = []
        for key in self.store.list(self.bucket, self.prefix + "/"):
            if key.endswith("/" + MANIFEST):
                part = key[len(self.prefix) + 1:].split("/")[0]
                if part.startswith("step_"):
                    steps.append(int(part[5:]))
        return max(steps) if steps else None

    def restore(self, step: int, like: Any, device=None, shardings: Any = None, mesh=None
                ) -> Tuple[Any, Dict[str, Any]]:
        """The checkpoint of ``step`` in the structure of ``like`` (a tree of
        tensors, DTensors or ``meta`` stand-ins: only shapes are read);
        returns (tree, the manifest's extra).  With ``shardings`` (a matching
        tree of ``sharding.P``) each leaf becomes a DTensor on ``mesh`` placed
        by its spec (reshard-on-load: the module docstring); else each leaf
        goes to ``device`` (default: the device of its counterpart in
        ``like``)."""
        if shardings is not None and mesh is None:
            raise ValueError("restore(shardings=...) places the leaves on a mesh: pass mesh=")
        stepdir = self._stepdir(step)
        manifest = json.loads(self.store.get(self.bucket, f"{stepdir}/{MANIFEST}"))
        flat_like = tree_leaves(like)
        entries = manifest["leaves"]
        if len(entries) != len(flat_like):
            raise ValueError(f"checkpoint has {len(entries)} leaves, "
                             f"model expects {len(flat_like)}")
        flat_sh = tree_leaves(shardings) if shardings is not None else [None] * len(flat_like)
        if len(flat_sh) != len(flat_like):
            raise ValueError(f"{len(flat_sh)} specs for a tree of {len(flat_like)} leaves")
        out = []
        for e, lk, spec in zip(entries, flat_like, flat_sh):
            t = _to_tensor(_load_npy(self.store.get(self.bucket, e["key"])), e["dtype"])
            if tuple(t.shape) != tuple(lk.shape):
                raise ValueError(f"{e['path']}: shape {tuple(t.shape)} != {tuple(lk.shape)}")
            if spec is not None:
                out.append(SH.distribute(t, mesh, spec))
            else:
                out.append(t.to(lk.device if device is None else device))
        return tree_unflatten(like, out), manifest["extra"]

    def restore_latest(self, like: Any, device=None, shardings: Any = None, mesh=None
                       ) -> Optional[Tuple[int, Any, Dict[str, Any]]]:
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like, device, shardings, mesh)
        return step, tree, extra

    # -- internals --------------------------------------------------------------

    def _stepdir(self, step: int) -> str:
        return f"{self.prefix}/step_{step:08d}"

    def _gc(self) -> None:
        steps = sorted({int(k[len(self.prefix) + 1:].split("/")[0][5:])
                        for k in self.store.list(self.bucket, self.prefix + "/")
                        if k.endswith("/" + MANIFEST)
                        and k[len(self.prefix) + 1:].startswith("step_")})
        for old in steps[:-self.keep] if self.keep > 0 else []:
            stepdir = self._stepdir(old)
            # delete manifest FIRST (uncommit), then leaves
            self.store.delete(self.bucket, f"{stepdir}/{MANIFEST}")
            for key in self.store.list(self.bucket, stepdir + "/"):
                self.store.delete(self.bucket, key)
