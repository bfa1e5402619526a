"""The reference's trace: nearest hit, the alpha-test loop and
visibility, in plain PyTorch, on the reference's own tables.

The semantics are the port's (``accel/intersect.py`` and the kernels it
dispatches to): backface culling (front-facing iff det < 0 for
det = e1 · (d × e2)), the nearest candidate hit in (t_min, t_max], a
committed hit on a ``needs_alpha`` triangle re-traced from just past it
when its texel alpha is below ALPHA_THRESHOLD (at most
``max_intersections`` rounds, then a miss), and visibility as the card
computes it: an opaque hit on the shadow set (candidates that are neither
sky nor alpha-tested) occludes, and so does an accepted hit on the
alpha-tested set.

The nearest hit is found by Möller–Trumbore tests, every multiply and
add rounded on its own, over the triangles of the clusters (CLUSTER_SIZE
consecutive triangles) whose padded box a ray enters, nearest box first,
until no untested box starts before the hit found. The hit's (t, u, v)
are then computed from the winning triangle's vertices as the port
computes them (its ``woop._recompute_tuv``): where the two sides pick the
same triangle they give the same bits. Exact ties go to the lowest
index. ``AccelScene.precision`` "bf16" rounds each hit's (t, u, v) to
bfloat16 (the comparison's control).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..models import atlas as atlas_mod
from ..models import materials
from ..models.types import CLUSTER_SIZE
from ..ops.linalg import as_f32
from .build import AccelScene

BIG = 3e38
DET_EPS = 1e-9
ALPHA_ADVANCE = 1e-3
# rays a chunk, and (ray, triangle) pairs a test step
_RAYS = 1 << 15
_PAIRS = 1 << 24


class HitRecord(NamedTuple):
    t: torch.Tensor  # f32[N] (3e38 on a miss)
    tri: torch.Tensor  # i32[N] (-1 on a miss)
    u: torch.Tensor  # f32[N]
    v: torch.Tensor  # f32[N]

    @property
    def hit(self) -> torch.Tensor:
        return self.tri >= 0


@contextlib.contextmanager
def alpha_loop_on_device():
    """The port's frame runs its alpha loop on the device in this block;
    the reference's loop reads the host either way."""
    yield


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)


def recompute_tuv(tri_attr, o, d, t_approx, tri):
    """(t, u, v) at the committed hit from the winning triangle's vertices
    (the port's ``woop._recompute_tuv``, operation for operation)."""
    vattr = tri_attr[torch.clamp_min(tri, 0).long(), 0:9]
    v0, v1, v2 = vattr[:, 0:3], vattr[:, 3:6], vattr[:, 6:9]
    e1 = v1 - v0
    e2 = v2 - v0
    nrm = _cross(e1, e2)
    dn = _dot(d, nrm)
    t = _dot(v0 - o, nrm) / torch.where(dn.abs() > 1e-20, dn, 1.0)
    p = o + t[:, None] * d
    q = p - v0
    d00 = _dot(e1, e1)
    d01 = _dot(e1, e2)
    d11 = _dot(e2, e2)
    d20 = _dot(q, e1)
    d21 = _dot(q, e2)
    denom = d00 * d11 - d01 * d01
    inv = 1.0 / torch.where(denom.abs() > 1e-18, denom, 1.0)
    u = (d11 * d20 - d01 * d21) * inv
    v = (d00 * d21 - d01 * d20) * inv
    hit = tri >= 0
    return torch.where(hit, t, t_approx), torch.where(hit, u, 0.0), torch.where(hit, v, 0.0)


def _boxes(v0, v1, v2, mask):
    """Padded boxes of each CLUSTER_SIZE run of ``mask``ed triangles
    (empty: lo = +1e30 > hi = -1e30), grown as the port's kernels grow
    theirs so that rounding never culls a hit."""
    c = v0.shape[0] // CLUSTER_SIZE
    pts = torch.stack([v0, v1, v2], dim=1).reshape(c, CLUSTER_SIZE * 3, 3)
    m = mask.reshape(c, CLUSTER_SIZE, 1).expand(c, CLUSTER_SIZE, 3).reshape(c, -1)[..., None]
    lo = torch.where(m, pts, 1e30).amin(dim=1)
    hi = torch.where(m, pts, -1e30).amax(dim=1)
    empty = ~m[..., 0].any(dim=1, keepdim=True)
    lo = torch.where(empty, 1e30, lo - (lo.abs() * 1e-5 + 1e-3))
    hi = torch.where(empty, -1e30, hi + (hi.abs() * 1e-5 + 1e-3))
    return lo, hi


def _entries(o, d, t_min, t_max, lo, hi):
    """[R, C] the t at which each ray enters each box within its interval
    (inf where it does not)."""
    inv = 1.0 / d
    near = t_min[:, None].expand(-1, lo.shape[0]).clone()
    far = t_max[:, None].expand(-1, lo.shape[0]).clone()
    for k in range(3):
        a = (lo[None, :, k] - o[:, k:k + 1]) * inv[:, k:k + 1]
        b = (hi[None, :, k] - o[:, k:k + 1]) * inv[:, k:k + 1]
        # 0 · inf is NaN where a ray lies in a box's face plane: fmin/fmax
        # drop it, which keeps the test conservative
        near = torch.fmax(near, torch.fmin(a, b))
        far = torch.fmin(far, torch.fmax(a, b))
    return torch.where(near <= far, near, torch.inf)


def _mt(o, d, t_lo, t_hi, v0, e1, e2, ok):
    """Möller–Trumbore on (ray, triangle) pairs: o, d as per-ray [A, 1]
    columns against [A, K] triangles; returns (t, u, v), t BIG where no
    hit."""
    ox, oy, oz = o
    dx, dy, dz = d
    px = dy * e2[..., 2] - dz * e2[..., 1]
    py = dz * e2[..., 0] - dx * e2[..., 2]
    pz = dx * e2[..., 1] - dy * e2[..., 0]
    det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
    front = det < -DET_EPS
    inv_det = torch.reciprocal(torch.where(front, det, -1.0))
    sx, sy, sz = ox - v0[..., 0], oy - v0[..., 1], oz - v0[..., 2]
    u = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1[..., 2] - sz * e1[..., 1]
    qy = sz * e1[..., 0] - sx * e1[..., 2]
    qz = sx * e1[..., 1] - sy * e1[..., 0]
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz) * inv_det
    hit = ok & front & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_lo) & (t <= t_hi)
    return torch.where(hit, t, BIG), u, v


def _nearest_chunk(o, d, t_min, t_max, v0, e1, e2, mask, lo, hi):
    """(t, tri, u, v) of the nearest hit of each ray of one chunk, (t, u,
    v) as the Möller–Trumbore test computes them."""
    n, dev = o.shape[0], o.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    entry = _entries(o, d, t_min, t_max, lo, hi)
    rows = torch.arange(n, device=dev)
    k = 4
    while rows.numel():
        ent = entry[rows]
        k = min(k, ent.shape[1])
        vals, idx = torch.topk(ent, k, dim=1, largest=False)
        near = vals <= best_t[rows, None]
        keep = near.any(dim=1)
        rows, ent, vals, idx, near = rows[keep], ent[keep], vals[keep], idx[keep], near[keep]
        if rows.numel() == 0:
            break
        step = max(1, _PAIRS // (k * CLUSTER_SIZE))
        for s in range(0, rows.numel(), step):
            r = rows[s:s + step]
            tri = (idx[s:s + step, :, None] * CLUSTER_SIZE
                   + torch.arange(CLUSTER_SIZE, device=dev)).reshape(r.numel(), -1)
            ok = (near[s:s + step, :, None].expand(-1, -1, CLUSTER_SIZE).reshape(r.numel(), -1)
                  & mask[tri])
            col = lambda x: [x[r, j:j + 1] for j in range(3)]
            t, u, v = _mt(col(o), col(d), t_min[r, None], t_max[r, None], v0[tri], e1[tri],
                          e2[tri], ok)
            tm = t.amin(dim=1)
            # the lowest index among the nearest
            j = torch.where(t == tm[:, None], tri, torch.iinfo(torch.int64).max).argmin(dim=1)
            ti = tri.gather(1, j[:, None])[:, 0]
            bt, bi = best_t[r], best_tri[r]
            better = (tm < BIG) & ((tm < bt) | ((tm == bt) & (ti < bi)))
            best_t[r] = torch.where(better, tm, bt)
            best_tri[r] = torch.where(better, ti, bi)
            best_u[r] = torch.where(better, u.gather(1, j[:, None])[:, 0], best_u[r])
            best_v[r] = torch.where(better, v.gather(1, j[:, None])[:, 0], best_v[r])
        ent.scatter_(1, idx, torch.inf)
        entry[rows] = ent
        rows = rows[(ent.amin(dim=1) <= best_t[rows])]
        k *= 4
    return best_t, best_tri, best_u, best_v


def intersect(accel: AccelScene, o, d, t_min, t_max, mask=None) -> HitRecord:
    """Nearest front-facing hit on the triangles of ``mask`` (default: the
    candidates), with the hit's (t, u, v) as the port computes them: on
    the card from the winning triangle's vertices, on the CPU (where the
    port runs its Möller–Trumbore oracle) the test's own."""
    n = o.shape[0]
    t_min = as_f32(t_min, o).expand(n).contiguous()
    t_max = as_f32(t_max, o).expand(n).contiguous()
    s = accel.scene
    mask = accel.candidate if mask is None else mask
    v0 = s.v0
    e1, e2 = s.v1 - v0, s.v2 - v0
    lo, hi = _boxes(s.v0, s.v1, s.v2, mask)
    parts = [_nearest_chunk(o[c:c + _RAYS], d[c:c + _RAYS], t_min[c:c + _RAYS],
                            t_max[c:c + _RAYS], v0, e1, e2, mask, lo, hi)
             for c in range(0, n, _RAYS)]
    if not parts:
        z = o.new_zeros((0,))
        return HitRecord(z, z.to(torch.int32), z, z)
    t, tri, u, v = (torch.cat(x) for x in zip(*parts))
    tri = tri.to(torch.int32)
    if o.is_cuda:
        t, u, v = recompute_tuv(accel.tri_attr, o, d, t, tri)
    if accel.precision == "bf16":
        t, u, v = (x.to(torch.bfloat16).to(torch.float32) for x in (t, u, v))
    return HitRecord(t=t, tri=tri, u=u, v=v)


def hit_uv(st, tri, u, v):
    s = st[torch.clamp_min(tri, 0).long()]
    w0 = (1.0 - u - v)[..., None]
    return s[:, 0] * w0 + s[:, 1] * u[..., None] + s[:, 2] * v[..., None]


def alpha_rejects(accel: AccelScene, atlas, tri, u, v):
    """Does the alpha test reject each hit: a hit on a ``needs_alpha``
    triangle whose texel alpha (nearest sample) is below ALPHA_THRESHOLD."""
    tri_c = torch.clamp_min(tri, 0).long()
    needs = accel.needs_alpha[tri_c] & (tri >= 0)
    a = atlas_mod.sample_nearest(atlas, accel.scene.texnum[tri_c],
                                 hit_uv(accel.scene.st, tri, u, v))[..., 3]
    return needs & (a < materials.ALPHA_THRESHOLD)


def _nearest_accepted(accel, tex, o, d, t_min, t_max, max_intersections, mask=None):
    """The alpha loop: each live ray's nearest hit past its current t_min;
    a rejected hit moves t_min past it, anything else is taken. A ray
    still live after ``max_intersections`` rounds misses."""
    n = o.shape[0]
    cur = as_f32(t_min, o).expand(n).clone()
    t_max = as_f32(t_max, o).expand(n)
    out = HitRecord(torch.full((n,), BIG, device=o.device),
                    torch.full((n,), -1, dtype=torch.int32, device=o.device),
                    torch.zeros((n,), device=o.device), torch.zeros((n,), device=o.device))
    live = torch.arange(n, device=o.device)
    for _ in range(max_intersections):
        if live.numel() == 0:
            break
        hr = intersect(accel, o[live], d[live], cur[live], t_max[live], mask)
        rej = alpha_rejects(accel, tex, hr.tri, hr.u, hr.v)
        take = live[~rej]
        for dst, x in zip(out, hr):
            dst[take] = x[~rej]
        cur[live[rej]] = hr.t[rej] + ALPHA_ADVANCE
        live = live[rej]
    return out


def trace_nearest(accel: AccelScene, tex, o, d, t_min, t_max,
                  max_intersections: int = materials.MAX_INTERSECTIONS, sort_rays=False,
                  schedule=None) -> HitRecord:
    """Nearest accepted hit (the alpha loop when ``tex`` is given). The
    port's ``sort_rays`` and ``schedule`` change no hit and are ignored."""
    if tex is None:
        return intersect(accel, o, d, t_min, t_max)
    return _nearest_accepted(accel, tex, o, d, t_min, t_max, max_intersections)


def trace_visibility(accel: AccelScene, tex, from_pos, to_pos, offset: float = 1e-3,
                     sort_rays=False, schedule=None) -> torch.Tensor:
    """Visibility between points, bool[N], as the card computes it: over
    [offset, max(offset, dist - 2·offset)], occluded by any hit on the
    shadow set and, when ``tex`` is given, by an accepted hit on the
    alpha-tested set."""
    wo = to_pos - from_pos
    dist = torch.linalg.vector_norm(wo, dim=-1)
    d = wo / torch.clamp_min(dist, 1e-20)[..., None]
    t_max = torch.clamp_min(dist - 2.0 * offset, offset)
    flags = accel.scene.flags
    shadow = accel.candidate & (flags != materials.MAT_FLAGS_SKY) & ~accel.needs_alpha
    vis = ~intersect(accel, from_pos, d, offset, t_max, shadow).hit
    alpha = accel.candidate & accel.needs_alpha
    if tex is not None and bool(alpha.any()):
        vis &= ~_nearest_accepted(accel, tex, from_pos, d, offset, t_max,
                                  materials.MAX_INTERSECTIONS, alpha).hit
    return vis
