"""Build the port's CUDA sources into plain-C shared libraries.

Each ``csrc/<name>.cu`` exposes ``extern "C"`` functions and is compiled by
``nvcc`` for ``sm_90a`` (Hopper) at first use, then loaded with ``ctypes``.
The library lands in ``build/torchok_tpu_torch/`` beside the package (git
ignores it) under a name that carries the hash of the source and of the
headers (``csrc/*.cuh``) it may include, so an edited source is rebuilt and
an unchanged one is loaded as is. A failed build raises with the compiler's
output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torchok_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()  # guards the two dicts below
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(put nvcc on PATH or set CUDA_HOME)")


def library_path(name: str) -> Path:
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    parts.append(" ".join(NVCC_FLAGS).encode())
    digest = hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``name``, or '' if it was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it.
    One lock per source: different sources build side by side."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        if name in _LOADED:
            return _LOADED[name]
        out = library_path(name)
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            out.with_suffix(".log").write_text(
                " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed to build {name}.cu "
                                   f"(exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        lib = ctypes.CDLL(str(out))
        _LOADED[name] = lib
        return lib


def load_function(name: str, argtypes: Sequence, symbol: str = "") -> Callable[..., int]:
    """The ``extern "C"`` entry ``symbol`` (by default ``name``) of
    ``csrc/<name>.cu`` (built at first use), taking ``argtypes`` and returning
    an int (a launch's CUDA error code)."""
    fn = getattr(load_library(name), symbol or name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def load_libraries(names: Sequence[str]) -> None:
    """Build (one ``nvcc`` per source, all started together) and load
    several libraries; the first failure raises."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for future in [pool.submit(load_library, n) for n in names]:
            future.result()
