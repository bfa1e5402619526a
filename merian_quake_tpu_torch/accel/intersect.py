"""Nearest-hit intersection with the alpha-test any-hit loop.

Port of merian_quake_tpu/accel/intersect.py. Semantics follow the
reference trace core (raytrace.glsl:82-119): backface culling with
n = cross(v2-v0, v1-v0) (front-facing iff det < 0), nearest candidate
hit, and committed hits on ``needs_alpha`` triangles re-traced from just
past the surface when the texel alpha is below ALPHA_THRESHOLD.

Dispatch is by device and nothing else: CPU tensors run the chunked
Möller–Trumbore oracle (what the JAX package runs on the CPU), CUDA
tensors run K1 (accel/woop.py, csrc/woop_nearest.cu) and, for
visibility, K2 (csrc/woop_any.cu).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import atlas as atlas_mod
from ..models import materials
from ..ops.linalg import as_f32
from .build import AccelScene

_BIG = 3e38
_DET_EPS = 1e-9
_ADVANCE = 1e-3  # re-trace offset past a rejected surface (quake units)
# (rays × triangles) elements per oracle step: bounds its temporaries
_ORACLE_PAIRS = 1 << 20
_ORACLE_RAYS = 1 << 16


class HitRecord(NamedTuple):
    t: torch.Tensor  # f32[N] hit distance (3e38 on a miss)
    tri: torch.Tensor  # i32[N] triangle index, -1 = miss
    u: torch.Tensor  # f32[N] barycentric weight of v1
    v: torch.Tensor  # f32[N] barycentric weight of v2

    @property
    def hit(self) -> torch.Tensor:
        return self.tri >= 0


def intersect(
    accel: AccelScene, o, d, t_min, t_max, sort_rays: bool = False
) -> HitRecord:
    """Nearest front-facing candidate hit. o, d: f32[N, 3].

    CUDA tensors go through K1 (``sort_rays`` bins incoherent rays
    first); CPU tensors run the oracle, where ``sort_rays`` changes
    nothing.
    """
    if o.is_cuda:
        from .woop import intersect_woop

        return intersect_woop(accel, o, d, t_min, t_max, sort_rays=sort_rays)
    if o.device.type != "cpu":
        raise ValueError(f"intersect: unsupported device {o.device}")
    return _intersect_oracle(accel, o, d, t_min, t_max)


def _intersect_oracle(accel: AccelScene, o, d, t_min, t_max) -> HitRecord:
    """Möller–Trumbore over all triangles, in triangle chunks with a
    running nearest hit (the lowest index wins exact ties)."""
    n = o.shape[0]
    t_min = as_f32(t_min, o).expand(n)
    t_max = as_f32(t_max, o).expand(n)
    if n > _ORACLE_RAYS:
        parts = [
            _intersect_oracle(accel, o[s:s + _ORACLE_RAYS], d[s:s + _ORACLE_RAYS],
                              t_min[s:s + _ORACLE_RAYS], t_max[s:s + _ORACLE_RAYS])
            for s in range(0, n, _ORACLE_RAYS)
        ]
        return HitRecord(*[torch.cat(x) for x in zip(*parts)])
    scene = accel.scene
    T = scene.num_tris
    chunk = min(T, max(64, _ORACLE_PAIRS // max(n, 1) // 64 * 64))

    best_t = torch.full((n,), _BIG, dtype=torch.float32, device=o.device)
    best_tri = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    best_u = torch.zeros((n,), device=o.device)
    best_v = torch.zeros((n,), device=o.device)
    rows = torch.arange(n, device=o.device)
    oo, dd = o[:, None, :], d[:, None, :]
    for c0 in range(0, T, chunk):
        sl = slice(c0, min(T, c0 + chunk))
        cv0, cv1, cv2 = scene.v0[sl], scene.v1[sl], scene.v2[sl]
        e1 = (cv1 - cv0)[None]  # (1, C, 3)
        e2 = (cv2 - cv0)[None]
        pvec = torch.linalg.cross(dd.expand(-1, e2.shape[1], -1), e2.expand(n, -1, -1), dim=-1)
        det = (e1 * pvec).sum(-1)  # (N, C)
        front = det < -_DET_EPS
        inv_det = 1.0 / torch.where(front, det, -1.0)
        tvec = oo - cv0[None]
        u = (tvec * pvec).sum(-1) * inv_det
        qvec = torch.linalg.cross(tvec, e1.expand(n, -1, -1), dim=-1)
        v = (dd * qvec).sum(-1) * inv_det
        t = (e2 * qvec).sum(-1) * inv_det
        ok = (
            front
            & accel.candidate[sl][None]
            & (u >= 0.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > t_min[:, None])
            & (t <= t_max[:, None])
        )
        t_m = torch.where(ok, t, _BIG)
        j = torch.argmin(t_m, dim=-1)  # first index of the minimum
        tj = t_m[rows, j]
        better = tj < best_t
        best_tri = torch.where(better, (c0 + j).to(torch.int32), best_tri)
        best_u = torch.where(better, u[rows, j], best_u)
        best_v = torch.where(better, v[rows, j], best_v)
        best_t = torch.where(better, tj, best_t)
    return HitRecord(t=best_t, tri=best_tri, u=best_u, v=best_v)


def _hit_uv(accel: AccelScene, hr: HitRecord) -> torch.Tensor:
    """Interpolated texture UV at the hit (st * barycentrics)."""
    st = accel.scene.st[torch.clamp_min(hr.tri, 0).long()]  # (N, 3, 2)
    w0 = (1.0 - hr.u - hr.v)[..., None]
    return st[:, 0] * w0 + st[:, 1] * hr.u[..., None] + st[:, 2] * hr.v[..., None]


def trace_nearest(
    accel: AccelScene,
    tex,
    o,
    d,
    t_min,
    t_max,
    max_intersections: int = materials.MAX_INTERSECTIONS,
    sort_rays: bool = False,
) -> HitRecord:
    """Nearest *accepted* hit: runs the alpha-test re-trace loop.

    ``tex``: TextureAtlas, or None to skip alpha testing (a single
    intersect sweep; callers pass None when SceneFeatures.has_alpha_tris
    says no triangle can alpha-reject).
    """
    if tex is None:
        return intersect(accel, o, d, t_min, t_max, sort_rays=sort_rays)
    n = o.shape[0]
    cur_tmin = as_f32(t_min, o).expand(n)
    t_max = as_f32(t_max, o).expand(n)
    result = HitRecord(
        t=torch.full((n,), _BIG, dtype=torch.float32, device=o.device),
        tri=torch.full((n,), -1, dtype=torch.int32, device=o.device),
        u=torch.zeros((n,), device=o.device),
        v=torch.zeros((n,), device=o.device),
    )
    active = torch.ones((n,), dtype=torch.bool, device=o.device)
    for _ in range(max_intersections):
        if not bool(active.any()):
            break
        hr = intersect(accel, o, d, cur_tmin, t_max, sort_rays=sort_rays)
        tri = torch.clamp_min(hr.tri, 0).long()
        needs = accel.needs_alpha[tri] & hr.hit
        uv = _hit_uv(accel, hr)
        a = atlas_mod.sample_nearest(tex, accel.scene.texnum[tri], uv)[..., 3]
        reject = needs & (a < materials.ALPHA_THRESHOLD)
        accept = active & ~reject
        result = HitRecord(*[torch.where(accept, x, r) for x, r in zip(hr, result)])
        cur_tmin = torch.where(reject & active, hr.t + _ADVANCE, cur_tmin)
        active = active & reject
    return result


def trace_visibility(accel: AccelScene, tex, from_pos, to_pos, offset: float = 1e-3,
                     sort_rays: bool = False) -> torch.Tensor:
    """Visibility between points, bool[N]; sky hits count as visible
    (raytrace.glsl:122-145). The segment is traced over
    [offset, max(offset, dist − 2·offset)].

    CPU tensors run what the JAX package runs on the CPU: the nearest
    accepted hit on the full table (alpha loop when ``tex`` is given),
    visible when it misses or hits sky. CUDA tensors run K2 on the
    shadow table (after the proxy pre-pass), then, when ``tex`` is given
    and the scene has alpha-tested triangles, a nearest + alpha-loop
    trace (K1) on the alpha-only table. The two differ only where an
    opaque surface lies behind a sky polygon within range: K2 calls it
    occluded, the oracle visible (real maps keep sky as the outer shell).
    """
    wo = to_pos - from_pos
    dist = torch.linalg.vector_norm(wo, dim=-1)
    d = wo / torch.clamp_min(dist, 1e-20)[..., None]
    t_max = torch.clamp_min(dist - 2.0 * offset, offset)
    if from_pos.is_cuda:
        return _visible_anyhit(accel, tex, from_pos, d, offset, t_max, sort_rays)
    if from_pos.device.type != "cpu":
        raise ValueError(f"trace_visibility: unsupported device {from_pos.device}")
    hr = trace_nearest(accel, tex, from_pos, d, offset, t_max)
    sky = accel.scene.flags[torch.clamp_min(hr.tri, 0).long()] == materials.MAT_FLAGS_SKY
    return ~hr.hit | sky


def _visible_anyhit(accel: AccelScene, tex, o, d, offset, t_max, sort_rays=False):
    """The card's visibility: K2 on the shadow table, then alpha-tested
    triangles resolved by a nearest + alpha-loop trace on the alpha-only
    table (the woop rows and AABBs swapped in; it goes through K1)."""
    from .woop import intersect_woop_any

    vis = ~intersect_woop_any(accel, o, d, offset, t_max, sort_rays=sort_rays)
    if tex is not None and accel.woop_w_alpha is not None:
        aacc = accel._replace(
            woop_w=accel.woop_w_alpha,
            cluster_lo=accel.cluster_lo_alpha,
            cluster_hi=accel.cluster_hi_alpha,
        )
        vis &= ~trace_nearest(aacc, tex, o, d, offset, t_max).hit
    return vis
