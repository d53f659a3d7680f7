"""S3-compatible object store analogue (local-dir and in-memory backends).

The port's own copy of ``repro.core.objectstore`` (the port imports nothing
of the JAX package): the same put/get/list/delete surface over a bucket
namespace, the same on-disk layout (``<root>/<bucket>/<key>``) and the same
atomic ``put`` (``mkstemp`` in the target directory, then ``os.replace``), so
a store written by either package reads in the other.  The checkpoint
manager writes through it.
"""
from __future__ import annotations

import os
import tempfile
import threading
from typing import Dict, List, Optional, Tuple


class NoSuchKey(KeyError):
    pass


class ObjectStore:
    def __init__(self, root: Optional[str] = None, endpoint: str = "s3.local"):
        self.endpoint = endpoint
        self._root = root
        self._mem: Dict[Tuple[str, str], bytes] = {}
        self._lock = threading.RLock()
        if root:
            os.makedirs(root, exist_ok=True)

    # -- S3 surface -------------------------------------------------------

    def put(self, bucket: str, key: str, data: bytes) -> None:
        if isinstance(data, str):
            data = data.encode()
        with self._lock:
            if self._root:
                path = self._path(bucket, key)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
                try:
                    with os.fdopen(fd, "wb") as f:
                        f.write(data)
                    os.replace(tmp, path)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
            self._mem[(bucket, key)] = bytes(data)

    def get(self, bucket: str, key: str) -> bytes:
        with self._lock:
            if self._root:
                try:
                    with open(self._path(bucket, key), "rb") as f:
                        return f.read()
                except FileNotFoundError:
                    raise NoSuchKey(f"s3://{bucket}/{key}")
            try:
                return self._mem[(bucket, key)]
            except KeyError:
                raise NoSuchKey(f"s3://{bucket}/{key}")

    def get_text(self, bucket: str, key: str) -> str:
        return self.get(bucket, key).decode()

    def exists(self, bucket: str, key: str) -> bool:
        try:
            self.get(bucket, key)
            return True
        except NoSuchKey:
            return False

    def delete(self, bucket: str, key: str) -> None:
        with self._lock:
            if self._root:
                try:
                    os.remove(self._path(bucket, key))
                except FileNotFoundError:
                    pass
            self._mem.pop((bucket, key), None)

    def list(self, bucket: str, prefix: str = "") -> List[str]:
        with self._lock:
            if self._root:
                broot = os.path.join(self._root, self._safe(bucket))
                out = []
                for dirpath, _, files in os.walk(broot):
                    for f in files:
                        rel = os.path.relpath(os.path.join(dirpath, f), broot)
                        key = rel.replace(os.sep, "/")
                        if key.startswith(prefix):
                            out.append(key)
                return sorted(out)
            return sorted(k for (b, k) in self._mem if b == bucket and k.startswith(prefix))

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def parse_ref(ref: str) -> Tuple[str, str]:
        """'bucket:key' -> (bucket, key), as in the paper's Fig. 1 yaml."""
        if ":" not in ref:
            raise ValueError(f"object ref {ref!r} is not 'bucket:key'")
        bucket, key = ref.split(":", 1)
        return bucket, key

    def _safe(self, s: str) -> str:
        return s.replace("/", "__")

    def _path(self, bucket: str, key: str) -> str:
        return os.path.join(self._root, self._safe(bucket), *key.split("/"))
