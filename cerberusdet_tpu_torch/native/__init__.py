"""Native host I/O: DCT-scaled JPEG decode through libjpeg(-turbo).

The port's counterpart of cerberusdet_tpu/native/__init__.py, with its own
copy of jpeg_io.cpp. The shared library is built with g++ at first use into
the git-ignored cerberusdet_tpu_torch/build/, one file per source text. Every
entry point returns None where the native path cannot help (no compiler, no
jpeglib.h, not a JPEG, a corrupt file), and the caller decodes with cv2.

Unlike the JAX package's binding, which marks the build as tried before it
has ended (so that concurrent first decodes take cv2 while one thread
compiles, and decode those images differently), a JpegDecoder holds every
caller on its lock until its one build attempt has ended: all decodes of a
run take the same decoder. Which one it is goes once to stderr.

This is host I/O for the data loader, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "jpeg_io.cpp"
BUILD_DIR = _HERE.parent / "build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


class JpegDecoder:
    """The scaled decoder, built into `build_dir` by the first call of
    `lib()`. Thread-safe: concurrent first callers wait for that one build
    attempt and then all see its outcome."""

    def __init__(self, build_dir=BUILD_DIR):
        self.build_dir = Path(build_dir)
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._done = False  # set, under the lock, only after _lib is final
        self.name = ""  # "native" or "cv2" once resolved

    def lib(self) -> Optional[ctypes.CDLL]:
        if self._done:
            return self._lib
        with self._lock:
            if not self._done:
                self._lib, why = self._load()
                self.name = "native" if self._lib is not None else "cv2"
                sys.stderr.write(f"cerberusdet_tpu_torch.native: JPEG decode by {why}\n")
                self._done = True
        return self._lib

    def _so_path(self) -> Path:
        key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
        return self.build_dir / f"libcerberus_io_{key[:16]}.so"

    def _load(self) -> Tuple[Optional[ctypes.CDLL], str]:
        so = self._so_path()
        if not so.exists():
            err = _build(so)
            if err:
                return None, f"cv2 (the native decoder did not build: {err})"
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            return None, f"cv2 (the native decoder did not load: {e})"
        lib.cdet_jpeg_scaled_dims.restype = ctypes.c_int
        lib.cdet_jpeg_scaled_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_ulong, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.cdet_decode_jpeg_scaled.restype = ctypes.c_int
        lib.cdet_decode_jpeg_scaled.argtypes = [
            ctypes.c_char_p, ctypes.c_ulong, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
        ]
        return lib, f"libjpeg, scaled in the DCT ({so})"

    def decode(self, data: bytes, max_long_side: int
               ) -> Optional[Tuple[np.ndarray, Tuple[int, int]]]:
        """Decode a JPEG at the smallest DCT scale whose long side is still
        >= max_long_side. Returns (RGB uint8 HWC array, (full_h, full_w)), or
        None where the native path is unavailable or the data is not a clean
        JPEG. The array is at least the target size; the caller makes the
        exact final resize, as after a full cv2 decode."""
        lib = self.lib()
        if lib is None or len(data) < 4 or data[:2] != b"\xff\xd8":
            return None
        oh, ow = ctypes.c_int(), ctypes.c_int()
        fh, fw = ctypes.c_int(), ctypes.c_int()
        rc = lib.cdet_jpeg_scaled_dims(data, len(data), max_long_side, ctypes.byref(oh),
                                       ctypes.byref(ow), ctypes.byref(fh), ctypes.byref(fw))
        if rc != 0 or oh.value <= 0 or ow.value <= 0:
            return None
        out = np.empty((oh.value, ow.value, 3), np.uint8)
        rc = lib.cdet_decode_jpeg_scaled(data, len(data), max_long_side,
                                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                                         oh.value, ow.value)
        if rc != 0:
            return None
        return out, (fh.value, fw.value)

    def imread(self, path: str, max_long_side: int
               ) -> Optional[Tuple[np.ndarray, Tuple[int, int]]]:
        """File variant of `decode`; None on any failure."""
        if not path.lower().endswith((".jpg", ".jpeg")):
            return None
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        return self.decode(data, max_long_side)


def _build(so: Path) -> str:
    """Compile jpeg_io.cpp into `so`; '' on success, else why not. Writes
    to a name of this process and renames, so that a concurrent build in
    another process never loads a half-written library."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), "-ljpeg"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{type(e).__name__}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else "g++ failed"
    os.replace(tmp, so)
    return ""


_DEFAULT = JpegDecoder()


def default_decoder() -> JpegDecoder:
    """The decoder the data pipeline uses (built into BUILD_DIR)."""
    return _DEFAULT


def imread_scaled(path: str, max_long_side: int
                  ) -> Optional[Tuple[np.ndarray, Tuple[int, int]]]:
    return default_decoder().imread(path, max_long_side)
