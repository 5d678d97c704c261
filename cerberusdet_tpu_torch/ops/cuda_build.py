"""Build the package's CUDA sources (csrc/*.cu) with nvcc and bind them by ctypes.

Each source compiles at first use into cerberusdet_tpu_torch/build/ as a
shared library with a plain C interface, once per source text and flag set.
Every pointer and the stream go to the C functions as c_void_p.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's kernels are built with the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def build(source: Path, verbose: bool = False) -> Path:
    """Compile `source` into build/ (once per source text and flag set) and
    return the library's path. verbose prints ptxas's register and shared
    memory report."""
    key = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"libcerberus_{source.stem}_{key[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr, end="")
    os.replace(tmp, lib)
    return lib


_FUNCS: Dict[Tuple[Path, str], ctypes._CFuncPtr] = {}


def load(source: Path, name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function `name` of `source`'s library (built if needed), with
    `argtypes` and an int return (the CUDA error code)."""
    if (source, name) not in _FUNCS:
        fn = getattr(ctypes.CDLL(str(build(source))), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[(source, name)] = fn
    return _FUNCS[(source, name)]
