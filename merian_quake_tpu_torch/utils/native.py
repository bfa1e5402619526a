"""ctypes bindings for the native (C++) accel builder.

Port of merian_quake_tpu/utils/native.py. The library is built here, at
first use, with ``g++`` from ``native/mq_native.cc`` (read, never
written) and native/Makefile's flags, into
``merian_quake_tpu_torch/_build/``; its file name carries a hash of the
source and the flags, so an edited source is rebuilt and a stale library
is never loaded. The JAX package's ``native/libmq_native.so`` is neither
loaded nor rebuilt. A failed build raises with the compiler's output:
nothing falls back to numpy unless the caller asks for it
(``accel.build.build_accel(..., native=False)``, the port's counterpart
of the JAX package's ``MQ_NO_NATIVE``).

With the Makefile's flags (``-O3 -march=native``, so g++ may contract
multiply-adds in the double-precision inverse) the Woop rows are the
JAX package's native rows bit for bit on the same machine; against the
numpy build they are equal in value and differ in the sign of some
zeros (tests/test_torch_native.py).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "mq_native.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
# native/Makefile's CXXFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread", "-Wall")

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)


def library_path() -> str:
    """Where the builder library of this checkout's source lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    with open(SOURCE, "rb") as src:
        h.update(src.read())
    return os.path.join(BUILD_DIR, f"libmq_native_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile native/mq_native.cc into ``_build/`` if this checkout's
    build is not there yet; returns the library's path. Raises with the
    compiler's output if the build fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the accel builder is built from native/mq_native.cc")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [cxx, *CXXFLAGS, "-shared", "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building the accel builder failed: {' '.join(cmd)} ({proc.returncode}):\n"
            f"{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


@functools.cache
def load() -> ctypes.CDLL:
    """The builder library (built on first use)."""
    lib = ctypes.CDLL(build_library())
    i64 = ctypes.c_int64
    lib.mq_morton_perm.argtypes = [_f32p, _f32p, _f32p, _u8p, _u8p, i64, _i32p]
    lib.mq_cluster_aabbs.argtypes = [_f32p, _f32p, _f32p, _u8p, i64, i64, _f32p, _f32p]
    lib.mq_build_woop.argtypes = [_f32p, _f32p, _f32p, _u8p, i64, i64, _f32p]
    lib.mq_version.restype = ctypes.c_int
    return lib


def _f32(a):
    a = np.ascontiguousarray(a, np.float32)
    return a, a.ctypes.data_as(_f32p)


def _u8(a):
    a = np.ascontiguousarray(a, np.uint8)
    return a, a.ctypes.data_as(_u8p)


def morton_perm(v0, v1, v2, candidate, valid) -> np.ndarray:
    """Morton order: candidates first, then valid non-candidates, then
    padding; ties keep their index order. Returns i32[T]."""
    (v0, p0), (v1, p1), (v2, p2) = _f32(v0), _f32(v1), _f32(v2)
    (cand, pc), (val, pv) = _u8(candidate), _u8(valid)
    out = np.empty((v0.shape[0],), np.int32)
    load().mq_morton_perm(p0, p1, p2, pc, pv, v0.shape[0], out.ctypes.data_as(_i32p))
    return out


def cluster_aabbs(v0, v1, v2, candidate, cluster_size: int):
    """Per-cluster AABBs over the candidate triangles (empty clusters:
    lo = +1e30, hi = -1e30). Returns (lo, hi) f32[T / cluster_size, 3]."""
    (v0, p0), (v1, p1), (v2, p2) = _f32(v0), _f32(v1), _f32(v2)
    cand, pc = _u8(candidate)
    c = v0.shape[0] // cluster_size
    lo = np.empty((c, 3), np.float32)
    hi = np.empty((c, 3), np.float32)
    load().mq_cluster_aabbs(p0, p1, p2, pc, v0.shape[0], cluster_size,
                            lo.ctypes.data_as(_f32p), hi.ctypes.data_as(_f32p))
    return lo, hi


def build_woop(v0, v1, v2, candidate, cluster_size: int):
    """Woop rows f32[3T, 8] of every triangle (candidacy not baked in) and
    the candidacy with degenerate triangles cleared."""
    (v0, p0), (v1, p1), (v2, p2) = _f32(v0), _f32(v1), _f32(v2)
    cand = np.array(candidate, np.uint8)
    w = np.zeros((3 * v0.shape[0], 8), np.float32)
    load().mq_build_woop(p0, p1, p2, cand.ctypes.data_as(_u8p), v0.shape[0], cluster_size,
                         w.ctypes.data_as(_f32p))
    return w, cand.astype(bool)
