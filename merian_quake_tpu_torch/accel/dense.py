"""Dense Möller–Trumbore sweep: the K8 kernel and its plain version.

Port of merian_quake_tpu/accel/pallas_intersect.py. Nothing on the frame
path calls it (the JAX package calls its kernel nowhere either); it is a
drop-in for ``accel.intersect`` that tests every triangle with no cull,
so on the card it checks the Woop kernels K1/K3 independently at any
scene size, where the CPU oracle is too slow.

- ``pack_tris``: the f32[16, T] triangle layout (v0, v1, v2 rows, the
  candidate flag, zeros).
- ``mt_nearest``: the arithmetic of the port's CPU oracle
  (``accel.intersect._intersect_oracle`` calls it) — one body for both.
- ``intersect_dense_reference``: that body on packed (rays, tris), the
  plain version of K8.
- ``mt_dense``: the wrapper of K8, ``csrc/mt_dense.cu``. A CUDA tensor
  launches the kernel; a CPU tensor runs the plain version.
- ``intersect_dense``: the HitRecord-level entry point (the counterpart
  of ``intersect_pallas``).
"""
from __future__ import annotations

import ctypes

import torch

from ..models.types import CLUSTER_SIZE
from ..ops.linalg import as_f32
from .woop import BIG, RAY_BLOCK, _check, _pack_rays

DET_EPS = 1e-9
# (rays × triangles) elements per step of the plain version: bounds its
# temporaries (2^20 on the CPU, 2^24 on a card)
_PAIRS_CPU, _PAIRS_CUDA = 1 << 20, 1 << 24
_MAX_RAYS = 1 << 16


def pack_tris(v0, v1, v2, candidate) -> torch.Tensor:
    """Scene SoA → f32[16, T] kernel layout: rows v0.xyz, v1.xyz, v2.xyz,
    the candidate flag (1.0 / 0.0), then zeros."""
    rows = [v0.T, v1.T, v2.T, candidate.to(torch.float32)[None]]
    packed = torch.cat(rows, dim=0)
    return torch.cat([packed, packed.new_zeros((16 - packed.shape[0], packed.shape[1]))]).contiguous()


def mt_nearest(o, d, t_min, t_max, v0, v1, v2, cand):
    """Nearest front-facing candidate hit over all triangles: (t, tri,
    u, v) per ray (3e38, -1, 0, 0 on a miss); the lowest index wins exact
    ties.

    o, d f32[N, 3]; t_min, t_max f32[N]; v0, v1, v2 f32[T, 3]; cand
    bool[T]. Runs in triangle chunks with a running nearest hit. Every
    component is its own elementwise op (no cross or sum kernel), so
    every multiply and add is rounded on its own, in the order
    csrc/mt_dense.cu follows.
    """
    n = o.shape[0]
    if n > _MAX_RAYS:
        parts = [
            mt_nearest(o[s:s + _MAX_RAYS], d[s:s + _MAX_RAYS], t_min[s:s + _MAX_RAYS],
                       t_max[s:s + _MAX_RAYS], v0, v1, v2, cand)
            for s in range(0, n, _MAX_RAYS)
        ]
        return tuple(torch.cat(x) for x in zip(*parts))
    T = v0.shape[0]
    pairs = _PAIRS_CUDA if o.is_cuda else _PAIRS_CPU
    chunk = min(T, max(64, pairs // max(n, 1) // 64 * 64))

    best_t = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros((n,), device=o.device)
    best_v = torch.zeros((n,), device=o.device)
    rows = torch.arange(n, device=o.device)
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))  # (N, 1)
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    t_lo, t_hi = t_min[:, None], t_max[:, None]
    for c0 in range(0, T, chunk):
        sl = slice(c0, min(T, c0 + chunk))
        a = v0[sl].T[:, None]  # (3, 1, C)
        e1 = (v1[sl].T - v0[sl].T)[:, None]
        e2 = (v2[sl].T - v0[sl].T)[:, None]
        px = dy * e2[2] - dz * e2[1]  # p = d × e2, (N, C)
        py = dz * e2[0] - dx * e2[2]
        pz = dx * e2[1] - dy * e2[0]
        det = e1[0] * px + e1[1] * py + e1[2] * pz
        front = det < -DET_EPS
        inv_det = torch.reciprocal(torch.where(front, det, -1.0))
        sx, sy, sz = ox - a[0], oy - a[1], oz - a[2]
        u = (sx * px + sy * py + sz * pz) * inv_det
        qx = sy * e1[2] - sz * e1[1]  # q = s × e1
        qy = sz * e1[0] - sx * e1[2]
        qz = sx * e1[1] - sy * e1[0]
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
        ok = (
            front
            & cand[sl][None]
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > t_lo)
            & (t <= t_hi)
        )
        t_m = torch.where(ok, t, BIG)
        j = torch.argmin(t_m, dim=-1)  # first index of the minimum
        tj = t_m[rows, j]
        better = tj < best_t
        best_tri = torch.where(better, (c0 + j).to(torch.int32), best_tri)
        best_u = torch.where(better, u[rows, j], best_u)
        best_v = torch.where(better, v[rows, j], best_v)
        best_t = torch.where(better, tj, best_t)
    return best_t, best_tri, best_u, best_v


def intersect_dense_reference(rays: torch.Tensor, tris: torch.Tensor):
    """Plain PyTorch version of K8: :func:`mt_nearest` on packed rays
    f32[8, n] and triangles f32[16, T] → (t, tri, u, v)."""
    return mt_nearest(
        rays[0:3].T, rays[3:6].T, rays[6], rays[7],
        tris[0:3].T, tris[3:6].T, tris[6:9].T, tris[9] > 0.5,
    )


def mt_dense(rays: torch.Tensor, tris: torch.Tensor):
    """K8: nearest hit of every ray over every triangle. Returns (t
    f32[n_pad], tri i32[n_pad], u f32[n_pad], v f32[n_pad]).

    rays f32[8, n_pad], n_pad a multiple of RAY_BLOCK; tris f32[16, T]
    (:func:`pack_tris`), T a multiple of CLUSTER_SIZE. On CUDA tensors
    this launches csrc/mt_dense.cu and counts the launch in
    ``mt_dense.launches``; on CPU tensors it runs
    :func:`intersect_dense_reference`.
    """
    dev = rays.device
    n_pad = rays.shape[1] if rays.dim() == 2 else -1
    T = tris.shape[1] if tris.dim() == 2 else -1
    if n_pad <= 0 or n_pad % RAY_BLOCK:
        raise ValueError(f"{n_pad} rays: must be a positive multiple of {RAY_BLOCK}")
    if T <= 0 or T % CLUSTER_SIZE:
        raise ValueError(f"{T} triangles: must be a positive multiple of {CLUSTER_SIZE}")
    _check("rays", rays, torch.float32, (8, n_pad), dev)
    _check("tris", tris, torch.float32, (16, T), dev)
    if dev.type == "cpu":
        return intersect_dense_reference(rays, tris)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out_t = torch.empty(n_pad, dtype=torch.float32, device=dev)
    out_tri = torch.empty(n_pad, dtype=torch.int32, device=dev)
    out_u = torch.empty(n_pad, dtype=torch.float32, device=dev)
    out_v = torch.empty(n_pad, dtype=torch.float32, device=dev)
    fn = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rays.data_ptr(), n_pad, tris.data_ptr(), T, RAY_BLOCK, out_t.data_ptr(),
                 out_tri.data_ptr(), out_u.data_ptr(), out_v.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mt_dense kernel launch failed: CUDA error {err}")
    mt_dense.launches += 1
    return out_t, out_tri, out_u, out_v


mt_dense.launches = 0


def _kernel_fn():
    from ..kernels import load_library

    fn = load_library("mt_dense").mq_mt_dense
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int64, p, ctypes.c_int64, ctypes.c_int, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def intersect_dense(accel, o, d, t_min, t_max):
    """Nearest front-facing candidate hit through K8 (CUDA tensors) or
    its plain version (CPU tensors): the same HitRecord as
    ``accel.intersect``, with u and v from the sweep itself."""
    from .intersect import HitRecord

    n = o.shape[0]
    rays = _pack_rays(o, d, as_f32(t_min, o).expand(n), as_f32(t_max, o).expand(n), RAY_BLOCK)
    s = accel.scene
    t, tri, u, v = mt_dense(rays, pack_tris(s.v0, s.v1, s.v2, accel.candidate))
    return HitRecord(t=t[:n], tri=tri[:n], u=u[:n], v=v[:n])
