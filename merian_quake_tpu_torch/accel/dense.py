"""Dense Möller–Trumbore sweep: the K8 kernel and its plain version.

Port of merian_quake_tpu/accel/pallas_intersect.py. Nothing on the frame
path calls it (the JAX package calls its kernel nowhere either); it is a
drop-in for ``accel.intersect`` that tests every triangle with no cull,
so on the card it checks the Woop kernels K1/K3 independently at any
scene size, where the CPU oracle is too slow.

- ``pack_tris``: the f32[16, T] triangle layout of the JAX package (v0,
  v1, v2 rows, the candidate flag, zeros).
- ``mt_table``: K8's layout, f32[T, 12], per triangle (v0, flag), (e1, 0),
  (e2, 0) with the edges rounded as the oracle rounds them;
  ``scene_table`` makes it once a scene.
- ``mt_nearest``: the arithmetic of the port's CPU oracle
  (``accel.intersect._intersect_oracle`` calls it) — one body, ``mt_edges``,
  for both.
- ``intersect_dense_reference``: that body on (rays, table), the plain
  version of K8.
- ``mt_dense``: the wrapper of K8, ``csrc/mt_dense.cu``. A CUDA tensor
  launches the kernel; a CPU tensor runs the plain version.
- ``intersect_dense``: the HitRecord-level entry point (the counterpart
  of ``intersect_pallas``).
"""
from __future__ import annotations

import torch

from ..models.types import CLUSTER_SIZE
from ..ops.linalg import as_f32
from .woop import (_I64, _INT, _P, BIG, RAY_BLOCK, _cached, _call, _check, _kernel_lib,
                   _pack_rays)

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


def mt_table(tris: torch.Tensor) -> torch.Tensor:
    """K8's triangle table f32[T, 12] from :func:`pack_tris`' f32[16, T]:
    per triangle (v0.xyz, flag), (e1.xyz, 0), (e2.xyz, 0), e1 = v1 - v0
    and e2 = v2 - v0 each rounded (the subtractions :func:`mt_nearest`
    makes), flag 1.0 / 0.0; 64 triangles are 3,072 contiguous bytes."""
    v0, v1, v2, flag = tris[0:3], tris[3:6], tris[6:9], tris[9:10]
    zero = torch.zeros_like(flag)
    return torch.cat([v0, flag, v1 - v0, zero, v2 - v0, zero]).T.contiguous()


def scene_table(accel) -> torch.Tensor:
    """:func:`mt_table` of the accel's triangles and candidate flags,
    computed once a scene (kept on ``accel.scene.v0``)."""
    s = accel.scene
    return _cached(s.v0, "mt_table", accel.candidate,
                   lambda: mt_table(pack_tris(s.v0, s.v1, s.v2, accel.candidate)))


def mt_nearest(o, d, t_min, t_max, v0, v1, v2, cand):
    """Nearest front-facing candidate hit over all triangles: (t, tri,
    u, v) per ray (3e38, -1, 0, 0 on a miss); the lowest index wins exact
    ties.

    o, d f32[N, 3]; t_min, t_max f32[N]; v0, v1, v2 f32[T, 3]; cand
    bool[T]. :func:`mt_edges` on the rounded edges v1 - v0, v2 - v0.
    """
    return mt_edges(o, d, t_min, t_max, v0, v1 - v0, v2 - v0, cand)


def mt_edges(o, d, t_min, t_max, v0, e1, e2, cand):
    """:func:`mt_nearest` on the edges e1, e2 f32[T, 3]. Runs in triangle
    chunks with a running nearest hit. Every component is its own
    elementwise op (no cross or sum kernel), so every multiply and add is
    rounded on its own, in the order csrc/mt_dense.cu follows.
    """
    n = o.shape[0]
    if n > _MAX_RAYS:
        parts = [
            mt_edges(o[s:s + _MAX_RAYS], d[s:s + _MAX_RAYS], t_min[s:s + _MAX_RAYS],
                     t_max[s:s + _MAX_RAYS], v0, e1, e2, cand)
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
        f1 = e1[sl].T[:, None]
        f2 = e2[sl].T[:, None]
        px = dy * f2[2] - dz * f2[1]  # p = d × e2, (N, C)
        py = dz * f2[0] - dx * f2[2]
        pz = dx * f2[1] - dy * f2[0]
        det = f1[0] * px + f1[1] * py + f1[2] * pz
        front = det < -DET_EPS
        inv_det = torch.reciprocal(torch.where(front, det, -1.0))
        sx, sy, sz = ox - a[0], oy - a[1], oz - a[2]
        u = (sx * px + sy * py + sz * pz) * inv_det
        qx = sy * f1[2] - sz * f1[1]  # q = s × e1
        qy = sz * f1[0] - sx * f1[2]
        qz = sx * f1[1] - sy * f1[0]
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (f2[0] * qx + f2[1] * qy + f2[2] * qz) * inv_det
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


def intersect_dense_reference(rays: torch.Tensor, table: torch.Tensor):
    """Plain PyTorch version of K8: :func:`mt_edges` on packed rays
    f32[8, n] and K8's table f32[T, 12] (:func:`mt_table`) → (t, tri,
    u, v)."""
    return mt_edges(
        rays[0:3].T, rays[3:6].T, rays[6], rays[7],
        table[:, 0:3], table[:, 4:7], table[:, 8:11], table[:, 3] > 0.5,
    )


# the arguments of K8's entry point: (rays, n_pad, table, T, block, keys,
# t, tri, u, v, counts, stream)
_ARGS = (_P, _I64, _P, _I64, _INT, _P, _P, _P, _P, _P, _P, _P)
# the columns of K8's ``counts=`` (int64[n_pad / RAY_BLOCK, 3]): per 128-ray
# block the (ray, triangle) pairs that pass pre-test level 1 (front and the
# flag), level 2 (and u's sign) and level 3 (and v's and t's: every
# pre-test), which then take the reciprocal and the exact test
COUNT_FIELDS = ("front", "u_sign", "pre_tested")


def mt_dense(rays: torch.Tensor, table: torch.Tensor, counts=None):
    """K8: nearest hit of every ray over every triangle. Returns (t
    f32[n_pad], tri i32[n_pad], u f32[n_pad], v f32[n_pad]).

    rays f32[8, n_pad], n_pad a multiple of RAY_BLOCK; table f32[T, 12]
    (:func:`mt_table`, :func:`scene_table`), T a multiple of
    CLUSTER_SIZE. On CUDA tensors this launches csrc/mt_dense.cu and
    counts the launch in ``mt_dense.launches``; on CPU tensors it runs
    :func:`intersect_dense_reference`. ``counts`` (None, or an int64[n_pad
    / RAY_BLOCK, 3] CUDA tensor, zeroed here) gets :data:`COUNT_FIELDS`.
    """
    dev = rays.device
    n_pad = rays.shape[1] if rays.dim() == 2 else -1
    T = table.shape[0] if table.dim() == 2 else -1
    if n_pad <= 0 or n_pad % RAY_BLOCK:
        raise ValueError(f"{n_pad} rays: must be a positive multiple of {RAY_BLOCK}")
    if T <= 0 or T % CLUSTER_SIZE:
        raise ValueError(f"{T} triangles: must be a positive multiple of {CLUSTER_SIZE}")
    _check("rays", rays, torch.float32, (8, n_pad), dev)
    _check("table", table, torch.float32, (T, 12), dev)
    if dev.type == "cpu":
        if counts is not None:
            raise ValueError("counts: only a kernel on the card counts its work")
        return intersect_dense_reference(rays, table)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if table.data_ptr() % 16:
        raise ValueError("table: must be 16-byte aligned (bulk copies)")
    cptr = None
    if counts is not None:
        _check("counts", counts, torch.int64, (n_pad // RAY_BLOCK, len(COUNT_FIELDS)), dev)
        cptr = counts.zero_().data_ptr()
    keys = torch.empty(n_pad, dtype=torch.int64, device=dev)
    out_t = torch.empty(n_pad, dtype=torch.float32, device=dev)
    out_tri = torch.empty(n_pad, dtype=torch.int32, device=dev)
    out_u = torch.empty(n_pad, dtype=torch.float32, device=dev)
    out_v = torch.empty(n_pad, dtype=torch.float32, device=dev)
    _call(_kernel_lib("mt_dense", None, _ARGS), dev, rays.data_ptr(), n_pad, table.data_ptr(), T,
          RAY_BLOCK, keys.data_ptr(), out_t.data_ptr(), out_tri.data_ptr(), out_u.data_ptr(),
          out_v.data_ptr(), cptr)
    mt_dense.launches += 1
    return out_t, out_tri, out_u, out_v


mt_dense.launches = 0


def intersect_dense(accel, o, d, t_min, t_max):
    """Nearest front-facing candidate hit through K8 (CUDA tensors) or
    its plain version (CPU tensors): the same HitRecord as
    ``accel.intersect``, with u and v from the sweep itself."""
    from .intersect import HitRecord

    n = o.shape[0]
    rays = _pack_rays(o, d, as_f32(t_min, o).expand(n), as_f32(t_max, o).expand(n), RAY_BLOCK)
    t, tri, u, v = mt_dense(rays, scene_table(accel))
    return HitRecord(t=t[:n], tri=tri[:n], u=u[:n], v=v[:n])
