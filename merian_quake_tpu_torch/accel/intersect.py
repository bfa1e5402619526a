"""Nearest-hit intersection with the alpha-test any-hit loop.

Port of merian_quake_tpu/accel/intersect.py. Semantics follow the
reference trace core (raytrace.glsl:82-119): backface culling with
n = cross(v2-v0, v1-v0) (front-facing iff det < 0), nearest candidate
hit, and committed hits on ``needs_alpha`` triangles re-traced from just
past the surface when the texel alpha is below ALPHA_THRESHOLD.

Dispatch is by device and nothing else: CPU tensors run the chunked
Möller–Trumbore oracle (what the JAX package runs on the CPU), CUDA
tensors run the Woop kernels of accel/woop.py: K1 (csrc/woop_nearest.cu)
and, for visibility, K2 (csrc/woop_any.cu), or K3 (csrc/woop_stream.cu)
for tables of more than RESIDENT_MAX_TRIS triangles, or, as a
``schedule`` (woop.TraceSchedule) asks, K4 and K5 (csrc/woop_keys.cu)
and the list walker (csrc/woop_list.cu). The alpha loop runs on the card
in one launch of the alpha walk (csrc/woop_alpha.cu, K1's or K3's walk)
on those two routes, and round by round on the walker's and on the CPU.
The oracle ignores ``schedule``, as it ignores ``sort_rays``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import torch

from ..models import materials
from ..ops.linalg import as_f32
from . import woop
from .build import AccelScene
from .dense import mt_nearest

_BIG = 3e38
_ADVANCE = woop.ALPHA_ADVANCE
# the t_max a dead ray is traced to: an empty interval, as a padding
# ray's (woop._pack_rays); a warp of such rays walks nothing
_DEAD_T_MAX = -1.0
_ON_DEVICE = contextvars.ContextVar("merian_alpha_loop_on_device", default=False)


@contextlib.contextmanager
def alpha_loop_on_device():
    """Within this block :func:`trace_nearest`'s round loop keeps its test
    on the device, as the JAX package's ``lax.while_loop`` does: it runs
    all ``max_intersections`` rounds and reads nothing from the host. A
    captured frame (renderer.compile_frame, Graph.compile) runs in it:
    a capture may not read the device, and its replays run every round.
    It matters only where the round loop runs on the card, the list
    walker's route (a schedule's node level, compaction or target key):
    the default routes run the whole loop in the alpha walk, which reads
    nothing from the host in or out of this block."""
    token = _ON_DEVICE.set(True)
    try:
        yield
    finally:
        _ON_DEVICE.reset(token)


class HitRecord(NamedTuple):
    t: torch.Tensor  # f32[N] hit distance (3e38 on a miss)
    tri: torch.Tensor  # i32[N] triangle index, -1 = miss
    u: torch.Tensor  # f32[N] barycentric weight of v1
    v: torch.Tensor  # f32[N] barycentric weight of v2

    @property
    def hit(self) -> torch.Tensor:
        return self.tri >= 0


def intersect(
    accel: AccelScene, o, d, t_min, t_max, sort_rays: bool = False, schedule=None
) -> HitRecord:
    """Nearest front-facing candidate hit. o, d: f32[N, 3].

    CUDA tensors go through ``woop.intersect_woop`` (K1, K3 or, as
    ``schedule`` asks, the walker; ``sort_rays`` bins incoherent rays
    first); CPU tensors run the oracle, where ``sort_rays`` and
    ``schedule`` change nothing.
    """
    if o.is_cuda:
        return woop.intersect_woop(accel, o, d, t_min, t_max, sort_rays=sort_rays,
                                   schedule=schedule)
    if o.device.type != "cpu":
        raise ValueError(f"intersect: unsupported device {o.device}")
    return _intersect_oracle(accel, o, d, t_min, t_max)


def _intersect_oracle(accel: AccelScene, o, d, t_min, t_max) -> HitRecord:
    """Möller–Trumbore over all triangles (accel/dense.py::mt_nearest, the
    plain version of K8): the lowest index wins exact ties."""
    n = o.shape[0]
    s = accel.scene
    return HitRecord(*mt_nearest(o, d, as_f32(t_min, o).expand(n), as_f32(t_max, o).expand(n),
                                 s.v0, s.v1, s.v2, accel.candidate))


def _hit_uv(accel: AccelScene, hr: HitRecord) -> torch.Tensor:
    """Interpolated texture UV at the hit (st * barycentrics)."""
    return woop.hit_uv(accel.scene.st, hr.tri, hr.u, hr.v)


def trace_nearest(
    accel: AccelScene,
    tex,
    o,
    d,
    t_min,
    t_max,
    max_intersections: int = materials.MAX_INTERSECTIONS,
    sort_rays: bool = False,
    schedule=None,
) -> HitRecord:
    """Nearest *accepted* hit: runs the alpha-test re-trace loop.

    ``tex``: TextureAtlas, or None to skip alpha testing (a single
    intersect sweep; callers pass None when SceneFeatures.has_alpha_tris
    says no triangle can alpha-reject).

    On the card, where the trace goes to K1 or K3 (no list walker:
    ``woop.walks_list``), the whole loop is one launch of the alpha walk
    (``woop.intersect_woop_alpha``): each warp stops after its last live
    ray, and nothing is read on the host. Otherwise each round
    (:func:`_alpha_round`) traces the rays still live; a dead ray is
    traced over an empty interval and does no triangle work. The eager
    round loop stops after the round that leaves no ray live (one host
    read a round); inside :func:`alpha_loop_on_device` it runs all
    ``max_intersections`` rounds with no host read. A round after the
    last live ray changes nothing, so all three give the same bits.
    """
    if tex is None:
        return intersect(accel, o, d, t_min, t_max, sort_rays=sort_rays, schedule=schedule)
    n = o.shape[0]
    if o.is_cuda and not woop.walks_list(accel, n, sort_rays, schedule):
        return woop.intersect_woop_alpha(accel, tex, o, d, t_min, t_max, max_intersections,
                                         sort_rays)
    cur_tmin = as_f32(t_min, o).expand(n)
    t_max = as_f32(t_max, o).expand(n)
    result = HitRecord(
        t=torch.full((n,), _BIG, dtype=torch.float32, device=o.device),
        tri=torch.full((n,), -1, dtype=torch.int32, device=o.device),
        u=torch.zeros((n,), device=o.device),
        v=torch.zeros((n,), device=o.device),
    )
    active = torch.ones((n,), dtype=torch.bool, device=o.device)
    on_device = _ON_DEVICE.get()
    for _ in range(max_intersections):
        if not on_device and not bool(active.any()):
            break
        active, cur_tmin, result = _alpha_round(accel, tex, o, d, active, cur_tmin, t_max, result,
                                                sort_rays, schedule)
    return result


def _alpha_round(accel, tex, o, d, active, cur_tmin, t_max, result, sort_rays=False,
                 schedule=None):
    """One round of the alpha loop: the nearest hit of each live ray past
    ``cur_tmin``; a hit that the texel's alpha rejects moves that ray's
    ``cur_tmin`` past it and keeps it live, any other result (a miss
    included) is taken and ends it. A dead ray is traced to
    ``_DEAD_T_MAX`` (an empty interval: no triangle work) and its result
    is discarded. Returns (active, cur_tmin, result)."""
    hr = intersect(accel, o, d, cur_tmin, torch.where(active, t_max, _DEAD_T_MAX),
                   sort_rays=sort_rays, schedule=schedule)
    reject = woop.alpha_rejects(woop.alpha_tables(accel, tex), hr.tri, hr.u, hr.v)
    accept = active & ~reject
    result = HitRecord(*[torch.where(accept, x, r) for x, r in zip(hr, result)])
    cur_tmin = torch.where(reject & active, hr.t + _ADVANCE, cur_tmin)
    return active & reject, cur_tmin, result


def trace_visibility(accel: AccelScene, tex, from_pos, to_pos, offset: float = 1e-3,
                     sort_rays: bool = False, schedule=None) -> torch.Tensor:
    """Visibility between points, bool[N]; sky hits count as visible
    (raytrace.glsl:122-145). The segment is traced over
    [offset, max(offset, dist − 2·offset)].

    CPU tensors run what the JAX package runs on the CPU: the nearest
    accepted hit on the full table (alpha loop when ``tex`` is given),
    visible when it misses or hits sky. CUDA tensors run K2 (K3 at map
    scale, or the walker at a ``schedule``'s node level) on the shadow
    table alone, with no proxy pre-pass (``woop.intersect_woop_any``),
    then, when ``tex`` is given and the scene has alpha-tested triangles, a
    nearest + alpha-loop trace (K1 or K3, by the table's size) on the
    alpha-only table. The two differ only where an
    opaque surface lies behind a sky polygon within range: K2 calls it
    occluded, the oracle visible (real maps keep sky as the outer shell).
    """
    wo = to_pos - from_pos
    dist = torch.linalg.vector_norm(wo, dim=-1)
    d = wo / torch.clamp_min(dist, 1e-20)[..., None]
    t_max = torch.clamp_min(dist - 2.0 * offset, offset)
    if from_pos.is_cuda:
        return _visible_anyhit(accel, tex, from_pos, d, offset, t_max, sort_rays, schedule)
    if from_pos.device.type != "cpu":
        raise ValueError(f"trace_visibility: unsupported device {from_pos.device}")
    hr = trace_nearest(accel, tex, from_pos, d, offset, t_max)
    sky = accel.scene.flags[torch.clamp_min(hr.tri, 0).long()] == materials.MAT_FLAGS_SKY
    return ~hr.hit | sky


def _visible_anyhit(accel: AccelScene, tex, o, d, offset, t_max, sort_rays=False,
                    schedule=None):
    """The card's visibility: K2, K3 or the walker on the shadow table, then
    alpha-tested triangles resolved by a nearest + alpha-loop trace on
    the alpha-only table (the woop rows and AABBs swapped in; it goes
    through the alpha walk, or the walker's round loop)."""
    vis = ~woop.intersect_woop_any(accel, o, d, offset, t_max, sort_rays=sort_rays,
                                   schedule=schedule)
    if tex is not None and accel.woop_w_alpha is not None:
        aacc = accel._replace(
            woop_w=accel.woop_w_alpha,
            cluster_lo=accel.cluster_lo_alpha,
            cluster_hi=accel.cluster_hi_alpha,
        )
        vis &= ~trace_nearest(aacc, tex, o, d, offset, t_max, schedule=schedule).hit
    return vis
