"""Build and load the port's hand-written CUDA kernels.

Each ``.cu`` source in ``fac_fake_torch/csrc/`` is compiled on first use by its own
``nvcc`` into a shared library with a plain C interface, loaded with
``ctypes``. All sources build in parallel (one ``nvcc`` each, started
together). Libraries land in ``build/fac_fake_torch_kernels/`` at the root
of the checkout, named by a hash of their source, the shared ``.cuh``
headers and the flags, so an edited source rebuilds and an unchanged one
loads as built.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so that no ``a·b+c``
is contracted into an FMA: the kernels then round every operation as their
plain PyTorch versions do. No ``--use_fast_math``: the NMS kernels need IEEE
division and NaN comparisons.

Every C entry point takes the CUDA stream last and returns
``cudaGetLastError()``; `check` raises on anything but 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "fac_fake_torch_kernels"
SOURCES = ("frame_detections", "normalize", "quant_dense", "quant_conv3d", "max_pool3d_i8",
           "clahe", "hard_nms", "kan_bases", "jpeg")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    "frame_detections": {"fac_frame_detections": [
        _P, _P, _P, _F, _F, _F, _I, _I, _I, _I, _F, _F, _I, _P, _P, _P]},
    "normalize": {"fac_normalize_imagenet": [
        _P, _P, ctypes.c_longlong, _I, ctypes.POINTER(_F), _P, _P]},
    "quant_dense": {"fac_quant_dense": [
        _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P]},
    "quant_conv3d": {"fac_quantize_pad": [_P, _I, _P, _P, _I, _I, _I, _P],
                     "fac_int8_conv3d": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                                         ctypes.POINTER(_I), _P]},
    "max_pool3d_i8": {"fac_max_pool3d_i8": [_P, _P, _I, _I, _I, _I, _I, _P]},
    "clahe": {"fac_clahe_subset": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]},
    "hard_nms": {"fac_hard_nms": [_P, _P, _P, _I, _I, _I, _F, _I, _P, _P, _P]},
    "kan_bases": {"fac_kan_bases": [_P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "jpeg": {"fac_jpeg_subset": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
             "fac_jpeg_div_check": [_P, _P]},
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: seconds the last `build` spent compiling (0 when every library was cached)
last_build_s = 0.0


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # the shared headers
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, Path]:
    """Compile every stale library in parallel; returns name → path.
    ``verbose`` adds ``-Xptxas -v`` and prints what the compiler says."""
    global last_build_s
    extra = ("-Xptxas", "-v") if verbose else ()
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    t0 = time.perf_counter()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, p)
        failed = []
        for n, (proc, tmp, p) in procs.items():
            out, _ = proc.communicate()
            if verbose and out:
                print(f"[nvcc {n}]\n{out}", flush=True)
            if proc.returncode != 0:
                failed.append(f"{n}: nvcc exit {proc.returncode}\n{out}")
                continue
            os.replace(tmp, p)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    last_build_s = time.perf_counter() - t0
    return paths


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built on first use."""
    with _lock:
        if name not in _libs:
            path = build([name])[name]
            so = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(so, fn).argtypes = argtypes
                getattr(so, fn).restype = ctypes.c_int
            _libs[name] = so
        return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(t, what: str, dtype=None, shape: Optional[tuple] = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype
    (and shape, where a dimension of None matches any size)."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if shape is not None and (len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape))):
        raise ValueError(f"{what}: expected shape {shape}, got {tuple(t.shape)}")
