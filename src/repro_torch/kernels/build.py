"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface. It is
compiled with ``nvcc`` for Hopper (``sm_90a``) at first use, into
``_build/`` beside this file, keyed by a hash of the source, and loaded
with :mod:`ctypes`. Nothing builds at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


#: {name: library} of the sources this process compiled (the run
#: manifest's ``kernel_builds`` reads it).
BUILT: Dict[str, Path] = {}


def source_digest(name: str) -> str:
    """The hash of ``csrc/<name>.cu`` that its library is keyed on."""
    return hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the library of the current ``csrc/<name>.cu`` is built."""
    return BUILD / f"lib{name}-{source_digest(name)}.so"


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless built already; returns the
    library's path and the compiler's log (ptxas register/spill report;
    empty when the library was already built)."""
    src = CSRC / f"{name}.cu"
    lib = library_path(name)
    if lib.exists():
        return lib, ""
    BUILD.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    os.replace(tmp, lib)
    BUILT[name] = lib
    return lib, res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first call)."""
    return ctypes.CDLL(str(build(name)[0]))
