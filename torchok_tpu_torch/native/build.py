"""Builds the port's JPEG library (decoder and encoder) (port of
``torchok_tpu.native.build``).

Compiles ``io_kernels.cpp`` with ``g++`` against libjpeg at first use into
``build/torchok_tpu_torch/native/`` beside the package (git ignores it),
under a name that carries the source's hash. A failed build raises with the
compiler's output: a JPEG is never handed to another reader.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

SRC = Path(__file__).with_name("io_kernels.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torchok_tpu_torch" / "native"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libtorchok_jpeg-{digest}.so"


def build_jpeg_library() -> Path:
    """The compiled library's path, building it if it is missing."""
    with _LOCK:
        out = library_path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = ["g++", *FLAGS, str(SRC), "-ljpeg", "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            os.unlink(tmp)
            raise RuntimeError(f"JPEG decoding and encoding need g++ and libjpeg: {' '.join(cmd)} "
                               f"failed: {e}") from e
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                "JPEG decoding and encoding need libjpeg (jpeglib.h and -ljpeg), and building "
                f"{SRC.name} against it failed (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        return out
