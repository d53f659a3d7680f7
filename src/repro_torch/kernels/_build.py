"""Build the CUDA kernels under ``csrc/`` into one shared library, and load it.

At first use, each ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a``, and the objects are linked into one ``.so``
under ``<repo>/build/kernels/``, named by a hash of the sources and flags, so
an unchanged tree reuses its build.  The library has a plain C interface and
is loaded with ``ctypes``; nothing here includes PyTorch's headers.

Importing this module builds nothing: the CPU tests import every module of
the package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points and their argument types: every pointer and the stream as
# c_void_p, ints as c_int, strides as c_longlong.
SIGNATURES: Dict[str, List] = {
    "repro_flash_attention_fwd": [_P] * 4 + [_I] * 5 + [_L] * 12 + [_I, _P],
    "repro_decode_attention_fwd": [_P] * 8 + [_I] * 6 + [_L] * 10 + [_I, _P],
    "repro_ssm_scan_fwd": [_P] * 5 + [_I] * 4 + [_L] * 2 + [_P],
    "repro_ssm_scan_fused_fwd": [_P] * 7 + [_I] * 4 + [_L] * 8 + [_P],
}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH): "
                       "the CUDA kernels are built from source at first use")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Tuple[Path, str, float]:
    """Compile (unless a build of these exact sources exists) and return
    (library path, compiler log, seconds spent building)."""
    lib = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    log_path = lib.with_suffix(".log")
    if lib.is_file():
        return lib, log_path.read_text() if log_path.is_file() else "", 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = BUILD_DIR / f"{lib.stem}.{tag}.so"
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                           *[str(obj) for _, obj, _ in jobs]],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    log = "\n".join(logs)
    log_path.write_text(log)
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib, log, time.perf_counter() - t0


_LOAD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first call.  ``lru_cache`` does
    not serialise concurrent first calls: threads that all miss (two serve
    replicas starting cold) would each run ``build`` into the same object
    and temporary names.  The lock lets one build and load; the others wait
    and take its library."""
    with _LOAD_LOCK:
        return _load()


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL:
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
