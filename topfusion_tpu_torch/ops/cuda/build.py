"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``topfusion_tpu_torch/csrc/<name>.cu`` has a plain C interface and
is compiled on first use into ``topfusion_tpu_torch/_build/``, keyed by
a hash of the source and the flags, so a changed source rebuilds and an
unchanged one loads at once.  Nothing is built at import time: this
module only runs ``nvcc`` when a wrapper launches a kernel.

Flags: ``sm_90a`` (Hopper), ``-fmad=false`` and no fast math, so that
every kernel computes float32 expressions with the same roundings as
the plain PyTorch versions beside them (IEEE division and sqrt are the
``nvcc`` defaults without ``--use_fast_math``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from $CUDA_HOME or the default toolkit
    location; raises if none exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, load it once
    per process, and return the ctypes handle.  The compiler's output
    (``-Xptxas -v``: registers, spills) is kept beside the library as
    ``.log``."""
    if name in _loaded:
        return _loaded[name]
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + res.stdout + res.stderr
        )
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu:\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, so)
    _loaded[name] = ctypes.CDLL(str(so))
    return _loaded[name]
