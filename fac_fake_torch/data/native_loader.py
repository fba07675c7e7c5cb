"""ctypes wrapper for the native C++ batch JPEG decoder — the port of
`fac_fake_tpu/data/native_loader.py`.

The port keeps its own copy of the decoder's source
(`fac_fake_torch/native/decoder.cpp`) and builds it on first use (``g++ -O3``
against libjpeg) into ``build/fac_fake_torch_native/`` at the root of the
checkout, which git ignores, named by a hash of the source. Where the
toolchain or libjpeg is missing, `available` is False and
`data/folder.py CropFolderDataset` decodes with cv2 instead.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fac_fake_torch_native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _so_path() -> Path:
    return BUILD_DIR / f"libfacdecoder-{hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]}.so"


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    so = _so_path()
    if not so.exists():
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(SRC),
                            "-o", str(tmp), "-ljpeg", "-pthread"],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
    return ctypes.CDLL(str(so))


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            lib = _build()
            if lib is not None:
                lib.fac_decode_batch.restype = ctypes.c_int
                lib.fac_decode_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int]
            _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def decode_batch(paths: List[str], size: int, threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Decode JPEGs into (n, size, size, 3) uint8 RGB and an ok mask (n,)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.uint8)
    ok = np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.fac_decode_batch(arr, n, size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), threads)
    return out, ok.astype(bool)
