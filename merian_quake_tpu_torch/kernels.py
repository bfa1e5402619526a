"""Build, load, bind and launch the hand-written CUDA kernels under
``csrc/``.

Each ``csrc/<name>.cu`` is a plain-C-interface source compiled by
``nvcc`` for ``sm_90a`` into a shared library and bound with ``ctypes``:
:func:`entry` binds one of its C entry points, :func:`launch` calls it on
the current stream, and :func:`check` holds a wrapper's tensor arguments
to what the kernel reads.
The library is built at first use, from the sources in this checkout
only, into ``_build/`` beside this file (listed in .gitignore). Its file
name carries a hash of the source and of every header under ``csrc/``
(``*.cuh``, which the sources include), so an edited source or header is
rebuilt and a stale library is never loaded. Nothing is built or loaded
on import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np
import torch

# every kernel source under csrc/: K1, K2, K3, K4 + K5 (woop_keys), the
# list walker K6 + K7 (woop_list), K8, the alpha walk (woop_alpha), the
# SVGF's temporal and à-trous kernels (svgf), MCPG's guide-state draws
# (mcpg_draw) and the u32 RNG and hash-grid chains (u32_chains)
KERNELS = ("woop_nearest", "woop_any", "woop_stream", "woop_keys", "woop_list", "mt_dense",
           "woop_alpha", "svgf", "mcpg_draw", "u32_chains")
_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            h.update(src.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_libraries(*names: str) -> None:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together. The compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside each library as
    ``<lib>.log``. Raises if any build fails."""
    started = []
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        started.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    failed = []
    for name, so, tmp, proc in started:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu ({proc.returncode}):\n{err}")
            continue
        with open(so + ".log", "w") as f:
            f.write(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and load it."""
    build_libraries(name)
    return ctypes.CDLL(library_path(name))


# the C types of the entry points' arguments: a pointer (a tensor's
# data_ptr(), or None), an int64, an int and a float
P, I64, INT, F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float


def f32(x: float) -> float:
    """A Python scalar as the float torch rounds it to in an f32 operation."""
    return float(np.float32(x))


def f32_recip(x: float) -> float:
    """The float reciprocal torch multiplies by on the card where an f32
    tensor is divided by the Python scalar ``x``."""
    return float(np.float32(1.0) / np.float32(x))


def entry(name: str, symbol, argtypes):
    """The C entry point ``symbol`` (default ``mq_<name>``) of
    ``csrc/<name>.cu``, taking ``argtypes`` and returning a CUDA error."""
    fn = getattr(load_library(name), symbol or f"mq_{name}")
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def launch(fn, device, *args) -> None:
    """Call a kernel's C entry point on ``device``'s current stream (the
    last argument); raise on a refused launch. The entry points launch,
    query (occupancy, a function attribute) and read the launch error:
    none synchronizes or allocates, so a CUDA graph captures them as
    they are, on the capture's stream."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {err}")


def check(name: str, x, dtype, shape, device, contiguous: bool = True) -> None:
    """Raise unless tensor ``x`` (argument ``name``) is ``dtype`` of
    ``shape`` on ``device`` and, with ``contiguous``, contiguous."""
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype}{tuple(shape)}, got {x.dtype}{tuple(x.shape)}"
        )
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
