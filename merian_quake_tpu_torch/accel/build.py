"""Host-side acceleration build: triangle classes + median-split clusters.

Port of merian_quake_tpu/accel/build.py::build_accel. The build runs on
the host, in the native C++ builder where the JAX package uses it
(utils/native.py: cluster AABBs, Woop rows, the Morton order) and in
numpy elsewhere, and the tables move to the requested device once.
``native=False`` builds every table in numpy (the JAX package's
fallbacks, its ``MQ_NO_NATIVE``): the plain version the tests hold the
native build to. ``cluster="morton"`` orders the triangles by Morton
code (the JAX package's ``MQ_CLUSTER=morton``) in place of the
median split. The build gives:

- per-triangle acceptance class for the any-hit loop: ``candidate``
  (participates in intersection) and ``needs_alpha`` (a committed hit
  must pass the texture alpha test);
- a cluster-aligned recursive median-split triangle order, with one
  AABB per CLUSTER_SIZE-triangle cluster;
- the Woop affine rows ``woop_w`` (accel/woop.py) and the packed
  shading attributes ``tri_attr``;
- the any-hit tables of K2 (build.py:231-296 of the JAX package): the
  shadow table (sky and alpha-tested triangles zeroed), the alpha-only
  table with its own AABBs, and the proxy table of the largest shadow
  candidates;
- the live game's tables (build.py:387-652 there): the static build once
  plus a dynamic suffix of fixed capacity, rewritten in place every
  frame by :func:`refresh_dynamic`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import materials
from ..models.types import CLUSTER_SIZE, Scene, SceneFeatures, TextureAtlas
from ..utils import native as _native
from ..utils import profiler
from . import woop
from .woop import bake_candidacy, build_woop, pack_table


class AccelScene(NamedTuple):
    """Scene + intersection metadata (leading dim T, cluster order)."""

    scene: Scene
    candidate: torch.Tensor  # bool[T] participates in intersection
    needs_alpha: torch.Tensor  # bool[T] committed hit requires texture alpha
    cluster_lo: torch.Tensor  # f32[C, 3] cluster AABB min
    cluster_hi: torch.Tensor  # f32[C, 3] cluster AABB max
    woop_w: torch.Tensor  # f32[3T, 8] unit-triangle affine rows (woop.py)
    tri_attr: torch.Tensor  # f32[T, 40] packed shading attributes
    world_lo: torch.Tensor  # f32[3] scene bounds (ray-sort quantization)
    world_hi: torch.Tensor
    # SHADOW table: sky + alpha-tested triangles zeroed (sky passes light,
    # raytrace.glsl:122-145; alpha resolved on the alpha-only table). The
    # same tensor as woop_w when the scene has neither.
    woop_w_shadow: torch.Tensor | None = None  # f32[3T, 8]
    # ALPHA-ONLY table: just the needs_alpha triangles, with their own
    # cluster AABBs (empty clusters: lo = +1e30, hi = -1e30). None when
    # no triangle is alpha-tested.
    woop_w_alpha: torch.Tensor | None = None  # f32[3T, 8]
    cluster_lo_alpha: torch.Tensor | None = None  # f32[C, 3]
    cluster_hi_alpha: torch.Tensor | None = None
    # PROXY table: the largest shadow candidates re-packed in their
    # cluster order. A sweep against it first occludes many rays with
    # genuine occluders (a subset of the shadow table), which the full
    # sweep then skips. None below 4,096 triangles.
    woop_w_proxy: torch.Tensor | None = None  # f32[3P, 8]
    cluster_lo_proxy: torch.Tensor | None = None  # f32[Cp, 3]
    cluster_hi_proxy: torch.Tensor | None = None

    @property
    def num_clusters(self) -> int:
        return self.cluster_lo.shape[0]


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def texture_alpha_flags(atlas: TextureAtlas) -> np.ndarray:
    """bool[MAX_TEX]: texture contains texels below ALPHA_THRESHOLD."""
    data = _np(atlas.data)
    table = _np(atlas.table)
    out = np.zeros((table.shape[0],), bool)
    for i, (x, y, w, h) in enumerate(table):
        if w == 0:
            continue
        region = data[y : y + h, x : x + w, 3]
        out[i] = bool((region < materials.ALPHA_THRESHOLD).any())
    return out


def _median_split_perm(v0, v1, v2, candidate, valid, chunk=CLUSTER_SIZE):
    """Cluster-aligned recursive median-split triangle order.

    Longest-axis median split snapped to CLUSTER_SIZE multiples, so
    leaves coincide with the kernel's clusters. Candidates first, then
    alpha-only valid triangles, then padding.
    """
    cent = ((v0 + v1 + v2) / 3.0).astype(np.float32)
    rank = np.where(candidate, 0, np.where(valid, 1, 2))
    out: list[np.ndarray] = []

    def split(idx: np.ndarray) -> None:
        if idx.shape[0] <= chunk:
            out.append(idx)
            return
        c = cent[idx]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        srt = idx[np.argsort(c[:, ax], kind="stable")]
        n = idx.shape[0]
        k = int(round((n // 2) / chunk)) * chunk
        k = max(chunk, min(((n - 1) // chunk) * chunk, k))
        split(srt[:k])
        split(srt[k:])

    split(np.nonzero(rank == 0)[0])
    return np.concatenate(
        out + [np.nonzero(rank == 1)[0], np.nonzero(rank == 2)[0]]
    )


def cluster_aabbs(v0, v1, v2, mask, chunk=CLUSTER_SIZE):
    """Per-cluster AABBs over ``mask``ed triangles; empty clusters get
    lo = +1e30, hi = -1e30 (never reached)."""
    c = v0.shape[0] // chunk
    pts = np.stack([v0, v1, v2], axis=1).reshape(c, chunk * 3, 3)
    cm = mask.reshape(c, chunk).repeat(3, axis=1).reshape(c, chunk * 3)
    big = np.float32(1e30)
    lo = np.where(cm[..., None], pts, big).min(axis=1)
    hi = np.where(cm[..., None], pts, -big).max(axis=1)
    empty = ~cm.any(axis=1)
    lo[empty] = big
    hi[empty] = -big
    return lo.astype(np.float32), hi.astype(np.float32)


def _morton3(x, y, z):
    """Interleave three 10-bit integer coordinate arrays (uint64)."""

    def spread(v):
        v = v & np.uint64(0x3FF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    return spread(x) | (spread(y) << np.uint64(1)) | (spread(z) << np.uint64(2))


def _morton_perm(v0, v1, v2, candidate, valid):
    """Morton order of the centroids: candidates first, then alpha-only
    valid triangles, then padding (numpy; the native builder's
    ``mq_morton_perm`` gives the same keys in the same order)."""
    cent = (v0 + v1 + v2) / 3.0
    lo = cent.min(axis=0)
    ext = np.maximum(cent.max(axis=0) - lo, 1e-6)
    q = np.clip(((cent - lo) / ext * 1023.0), 0, 1023).astype(np.uint64)
    codes = _morton3(q[:, 0], q[:, 1], q[:, 2])
    rank = np.where(candidate, 0, np.where(valid, 1, 2)).astype(np.uint64)
    return np.lexsort((codes, rank))


def build_accel(
    scene: Scene, atlas: TextureAtlas | None = None, device=None, cluster: str = "median",
    native: bool = True,
) -> AccelScene:
    """Build the accel tables on the host; place them on ``device``
    (default: the scene's device). ``cluster``: "median" (the
    cluster-aligned median split) or "morton"; ``native``: the C++
    builder (utils/native.py, built on first use; a failed build
    raises) or numpy."""
    if cluster not in ("median", "morton"):
        raise ValueError(f"unknown cluster order {cluster!r}")
    device = scene.v0.device if device is None else device
    host = [_np(a) for a in scene]
    sc = Scene(*host)
    valid, flags, alpha, texnum = sc.valid, sc.flags, sc.alpha, sc.texnum

    # --- acceptance classes (raytrace.glsl:95-119 semantics) ---
    flag_opaque = (flags > 0) & (flags < 7)
    has_override = alpha >= 0.0
    override_accept = has_override & (alpha >= materials.ALPHA_THRESHOLD)
    override_reject = has_override & (alpha < materials.ALPHA_THRESHOLD)
    if atlas is not None:
        tex_has_alpha = texture_alpha_flags(atlas)[np.clip(texnum, 0, None)]
    else:
        tex_has_alpha = np.zeros_like(valid)
    needs_alpha = valid & ~flag_opaque & ~has_override & tex_has_alpha
    candidate = valid & ~override_reject & (
        flag_opaque | override_accept | ~has_override
    )

    if cluster == "median":
        perm = _median_split_perm(sc.v0, sc.v1, sc.v2, candidate, valid)
    elif native:
        perm = _native.morton_perm(sc.v0, sc.v1, sc.v2, candidate, valid)
    else:
        perm = _morton_perm(sc.v0, sc.v1, sc.v2, candidate, valid)
    sc = Scene(*[a[perm] for a in host])
    candidate = candidate[perm]
    needs_alpha = needs_alpha[perm]
    v0, v1, v2 = sc.v0, sc.v1, sc.v2
    T = v0.shape[0]

    if native:
        aabbs = lambda a, b, c, mask: _native.cluster_aabbs(a, b, c, mask, CLUSTER_SIZE)
        woop_w, woop_cand = _native.build_woop(v0, v1, v2, candidate, CLUSTER_SIZE)
        woop_w = bake_candidacy(woop_w, woop_cand)
    else:
        aabbs = cluster_aabbs
        woop_w, _ = build_woop(v0, v1, v2, candidate)
    lo_c, hi_c = aabbs(v0, v1, v2, candidate)
    anyhit = _anyhit_tables(v0, v1, v2, sc.flags, candidate, needs_alpha, woop_w, aabbs)

    attr = np.zeros((T, 40), np.float32)
    attr[:, 0:3] = v0
    attr[:, 3:6] = v1
    attr[:, 6:9] = v2
    attr[:, 9:12] = sc.pv0
    attr[:, 12:15] = sc.pv1
    attr[:, 15:18] = sc.pv2
    attr[:, 18:24] = sc.st.reshape(T, 6)
    attr[:, 24] = sc.texnum
    attr[:, 25] = sc.fb_texnum
    attr[:, 26] = sc.gloss_texnum
    attr[:, 27] = sc.flags
    attr[:, 28:31] = sc.solid_albedo
    attr[:, 31:34] = sc.solid_emission
    attr[:, 34] = sc.normal_texnum
    # texel density (texels per world unit) for ray-cone mip selection
    sd0 = sc.st[:, 1] - sc.st[:, 0]
    sd1 = sc.st[:, 2] - sc.st[:, 0]
    uv_area = 0.5 * np.abs(sd0[:, 0] * sd1[:, 1] - sd0[:, 1] * sd1[:, 0])
    w_area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    if atlas is not None:
        tdim = _np(atlas.table)[np.clip(sc.texnum, 0, None)]
        tex_px = np.maximum(tdim[:, 2] * tdim[:, 3], 1).astype(np.float64)
    else:
        tex_px = np.full((T,), 64.0 * 64.0)
    attr[:, 35] = np.sqrt(
        uv_area * tex_px / np.maximum(w_area, 1e-9)
    ).astype(np.float32)

    vmask = valid[:, None]
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    # every Woop table gets its packed rows (K1's and K3's bulk copies) here,
    # once, where it is placed on the device
    table = lambda k, a: pack_table(dev(a)) if k.startswith("woop_w") else dev(a)
    woop_w_dev = pack_table(dev(woop_w))
    extra = {
        k: (woop_w_dev if a is woop_w else None if a is None else table(k, a))
        for k, a in anyhit.items()
    }
    return AccelScene(
        scene=Scene(*[dev(a) for a in sc]),
        candidate=dev(candidate),
        needs_alpha=dev(needs_alpha),
        cluster_lo=dev(lo_c.astype(np.float32)),
        cluster_hi=dev(hi_c.astype(np.float32)),
        woop_w=woop_w_dev,
        tri_attr=dev(attr),
        world_lo=dev(np.nanmin(np.where(vmask, host[0], np.nan), axis=0).astype(np.float32)),
        world_hi=dev(np.nanmax(np.where(vmask, host[0], np.nan), axis=0).astype(np.float32)),
        **extra,
    )


def _anyhit_tables(v0, v1, v2, flags, candidate, needs_alpha, woop_w,
                   aabbs=cluster_aabbs) -> dict:
    """The shadow, alpha-only and proxy tables of K2 (host arrays; None
    where the scene has no such table). The shadow table *is* ``woop_w``
    when it zeroes nothing. ``aabbs``: the cluster-AABB builder (native
    or numpy); the proxy's Woop rows are numpy's on both routes, as in
    the JAX package."""
    T = v0.shape[0]
    shadow_cand = candidate & (flags != materials.MAT_FLAGS_SKY) & ~needs_alpha
    out = dict.fromkeys(
        ("woop_w_alpha", "cluster_lo_alpha", "cluster_hi_alpha",
         "woop_w_proxy", "cluster_lo_proxy", "cluster_hi_proxy")
    )
    out["woop_w_shadow"] = (
        woop_w if shadow_cand.sum() == candidate.sum()
        else bake_candidacy(woop_w, shadow_cand)
    )
    alpha_cand = candidate & needs_alpha
    if alpha_cand.any():
        out["woop_w_alpha"] = bake_candidacy(woop_w, alpha_cand)
        out["cluster_lo_alpha"], out["cluster_hi_alpha"] = aabbs(v0, v1, v2, alpha_cand)
    # proxy: the largest shadow candidates (by twice their area), in
    # their cluster order
    n_shadow = int(shadow_cand.sum())
    if T >= 4096 and n_shadow >= CLUSTER_SIZE:
        area2 = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
        area2 = np.where(shadow_cand, area2, -1.0)
        nc_proxy = int(np.clip((T // CLUSTER_SIZE) // 16, 2, 64))
        n_proxy = min(nc_proxy * CLUSTER_SIZE, n_shadow)
        n_proxy -= n_proxy % CLUSTER_SIZE
        sel = np.sort(np.argpartition(-area2, n_proxy - 1)[:n_proxy])
        pv0, pv1, pv2 = v0[sel], v1[sel], v2[sel]
        out["woop_w_proxy"], pcand = build_woop(pv0, pv1, pv2, shadow_cand[sel])
        out["cluster_lo_proxy"], out["cluster_hi_proxy"] = aabbs(pv0, pv1, pv2, pcand)
    return out


class LiveAccel(NamedTuple):
    """The live game's accel (build.py:387-404 of the JAX package): the
    static tables, built once, then a DYNAMIC suffix of ``dyn_cap`` rows
    (cluster-aligned) in every table, which :func:`refresh_dynamic`
    rewrites each frame in place, so that a frame costs O(dynamic), not
    O(map) (the reference's BLAS refit, quake_node.cpp:896-1012)."""

    accel: AccelScene  # full tables: static prefix + dynamic suffix
    n_static: int  # static triangle rows (cluster-aligned)
    dyn_cap: int  # dynamic capacity (cluster-aligned)
    tex_alpha: np.ndarray  # bool[MAX_TEX] texture has alpha
    tex_px: np.ndarray  # f64[MAX_TEX] texel count (mip density)


def build_accel_live(bundle, dyn_cap: int = 4096, device="cuda") -> LiveAccel:
    """One-time static build + dynamic-suffix allocation, on ``device``.

    ``bundle``: the SceneBundle of the STATIC map. ``dyn_cap`` must be
    the GameState's dynamic_capacity, rounded here to a cluster
    multiple. Every table of the result is a tensor of its own: the
    shadow table never aliases ``woop_w`` (as it may in :func:`build_accel`),
    and the alpha-only table and its AABBs are allocated at full size
    even when the static map has no alpha-tested triangle (the dynamic
    sprites may have some), as in the JAX package (build.py:445-460).
    Each Woop table carries its packed rows (``woop.pack_table``).
    """
    scene, atlas = bundle.scene, bundle.atlas
    dyn_cap = -(-dyn_cap // CLUSTER_SIZE) * CLUSTER_SIZE
    acc = build_accel(scene, atlas, device=device)
    t0 = acc.scene.num_tris
    ncd = dyn_cap // CLUSTER_SIZE
    big = 1e30
    nc = acc.num_clusters

    def grow(x, fill=0):
        return torch.cat([x, x.new_full((dyn_cap,) + tuple(x.shape[1:]), fill)])

    def grow_table(w):
        return pack_table(torch.cat([w, w.new_zeros((3 * dyn_cap, 8))]))

    def boxes(lo, hi):
        lo = acc.cluster_lo.new_full((nc, 3), big) if lo is None else lo
        hi = acc.cluster_hi.new_full((nc, 3), -big) if hi is None else hi
        return (torch.cat([lo, lo.new_full((ncd, 3), big)]),
                torch.cat([hi, hi.new_full((ncd, 3), -big)]))

    sc = acc.scene
    new_scene = Scene(*[
        grow(x, -1.0 if k == "alpha" else False if k == "valid" else 0)
        for k, x in zip(Scene._fields, sc)
    ])
    shadow = acc.woop_w if acc.woop_w_shadow is None else acc.woop_w_shadow
    alpha = torch.zeros_like(acc.woop_w) if acc.woop_w_alpha is None else acc.woop_w_alpha
    lo, hi = boxes(acc.cluster_lo, acc.cluster_hi)
    lo_a, hi_a = boxes(acc.cluster_lo_alpha, acc.cluster_hi_alpha)
    table = _np(atlas.table)
    acc2 = acc._replace(
        scene=new_scene,
        candidate=grow(acc.candidate, False),
        needs_alpha=grow(acc.needs_alpha, False),
        cluster_lo=lo,
        cluster_hi=hi,
        woop_w=grow_table(acc.woop_w),
        tri_attr=grow(acc.tri_attr),
        woop_w_shadow=grow_table(shadow),
        woop_w_alpha=grow_table(alpha),
        cluster_lo_alpha=lo_a,
        cluster_hi_alpha=hi_a,
    )
    return LiveAccel(
        accel=acc2,
        n_static=t0,
        dyn_cap=dyn_cap,
        tex_alpha=texture_alpha_flags(atlas),
        tex_px=np.maximum(table[:, 2] * table[:, 3], 1).astype(np.float64),
    )


def dynamic_rows(la: LiveAccel, dyn: dict) -> dict:
    """The dynamic suffix's rows of every table, host arrays, from
    ``GameState.extract_dynamic()``'s block (build.py:574-640 of the JAX
    package, without its TPU-only fine tables): the scene fields, the
    candidacy, the cluster AABBs, the Woop rows of the nearest, shadow and
    alpha-only tables and the shading attributes (the JAX package's
    ``_aabbs_np`` is :func:`cluster_aabbs`)."""
    cap = la.dyn_cap
    pad = cap - dyn["v"].shape[0]
    pd = (
        (lambda a: np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]))
        if pad
        else (lambda a: a)
    )
    v0, v1, v2 = pd(dyn["v"][:, 0]), pd(dyn["v"][:, 1]), pd(dyn["v"][:, 2])
    pv0, pv1, pv2 = pd(dyn["prev"][:, 0]), pd(dyn["prev"][:, 1]), pd(dyn["prev"][:, 2])
    valid = pd(dyn["valid"])
    flags = pd(dyn["flags"])
    tex = pd(dyn["tex"])
    fb = pd(dyn["fb"])
    uv = pd(dyn["uv"])
    salb = pd(dyn["salb"])
    semm = pd(dyn["semm"])

    flag_opaque = (flags > 0) & (flags < 7)
    needs_alpha = valid & ~flag_opaque & la.tex_alpha[np.clip(tex, 0, None)]
    w, cand = build_woop(v0, v1, v2, valid, chunk=CLUSTER_SIZE)
    w = bake_candidacy(w, cand)
    lo, hi = cluster_aabbs(v0, v1, v2, cand)
    sky = flags == materials.MAT_FLAGS_SKY
    shadow_cand = cand & ~sky & ~needs_alpha
    w_shadow = bake_candidacy(w, shadow_cand)
    alpha_cand = cand & needs_alpha
    w_alpha = bake_candidacy(w, alpha_cand)
    lo_a, hi_a = cluster_aabbs(v0, v1, v2, alpha_cand)

    attr = np.zeros((cap, 40), np.float32)
    attr[:, 0:3], attr[:, 3:6], attr[:, 6:9] = v0, v1, v2
    attr[:, 9:12], attr[:, 12:15], attr[:, 15:18] = pv0, pv1, pv2
    attr[:, 18:24] = uv.reshape(cap, 6)
    attr[:, 24] = tex
    attr[:, 25] = fb
    attr[:, 27] = flags
    attr[:, 28:31] = salb
    attr[:, 31:34] = semm
    sd0 = uv[:, 1] - uv[:, 0]
    sd1 = uv[:, 2] - uv[:, 0]
    uv_area = 0.5 * np.abs(sd0[:, 0] * sd1[:, 1] - sd0[:, 1] * sd1[:, 0])
    w_area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    tpx = la.tex_px[np.clip(tex, 0, len(la.tex_px) - 1)]
    attr[:, 35] = np.sqrt(uv_area * tpx / np.maximum(w_area, 1e-9)).astype(np.float32)
    return dict(
        v0=v0, v1=v1, v2=v2, pv0=pv0, pv1=pv1, pv2=pv2,
        st=uv, texnum=tex, fb=fb, flags=flags, salb=salb, semm=semm,
        valid=valid, cand=cand, needs_alpha=needs_alpha,
        lo=lo, hi=hi, lo_a=lo_a, hi_a=hi_a,
        w=w, w_shadow=w_shadow, w_alpha=w_alpha, attr=attr,
    )


def _write(dst: torch.Tensor, at: int, rows: np.ndarray) -> int:
    """Write host ``rows`` into ``dst`` from row ``at`` on, in place (on
    the card through pinned memory, ordered on the current stream);
    returns the bytes copied."""
    src = torch.from_numpy(np.ascontiguousarray(rows)).to(dst.dtype)
    if dst.is_cuda:
        src = src.pin_memory()
    dst[at : at + src.shape[0]].copy_(src, non_blocking=dst.is_cuda)
    return src.numel() * src.element_size()


def _write_table(w: torch.Tensor, at: int, rows: np.ndarray) -> int:
    """:func:`_write` into a Woop table and its packed rows ``w.rows4``,
    which K1, K2 and K3 read in its place (a copy, not a view)."""
    n = _write(w, at, rows)
    woop.packed_rows(w)[at:].copy_(w[at:, :4])
    return n


def refresh_dynamic(la: LiveAccel, dyn: dict) -> LiveAccel:
    """Per-frame dynamic-suffix refresh (≈ BLAS refit + re-upload).

    ``dyn``: ``GameState.extract_dynamic()``'s block. The host cost is
    numpy over ``dyn_cap`` triangles (:func:`dynamic_rows`); the device
    cost is a row write of the suffix of every table, in place, a few MB
    over the host-to-device link. The JAX package makes new tables with
    donated buffers instead (``_apply_dyn_jit``, build.py:514-571); here
    each table keeps its storage, and so does what the tracers derived
    and kept from it, which is made anew in place: the packed rows of the
    three Woop tables are rewritten with them, and the padded bounds, the
    node, sub-node and cluster boxes (kept on ``cluster_lo`` and
    ``cluster_lo_alpha``) and K8's triangle table (kept on ``scene.v0``)
    are computed again into the tensors that hold them
    (:func:`_rewrite_derived`). A frame captured on these tables
    (renderer.compile_frame) therefore reads this refresh's values on its
    next replay: the copies are ordered before it on the current stream.
    No device value is read. Returns ``la``, whose tables now hold this
    frame; ``refresh_dynamic.h2d_bytes`` is what the last call copied to
    the device."""
    with profiler.span("refresh.rows"):
        u = dynamic_rows(la, dyn)
    with profiler.span("refresh.write"):
        t0 = la.n_static
        c0 = t0 // CLUSTER_SIZE
        a = la.accel
        sc = a.scene
        n = 0
        for field, key in (("v0", "v0"), ("v1", "v1"), ("v2", "v2"), ("pv0", "pv0"),
                           ("pv1", "pv1"), ("pv2", "pv2"), ("st", "st"), ("texnum", "texnum"),
                           ("fb_texnum", "fb"), ("flags", "flags"), ("solid_albedo", "salb"),
                           ("solid_emission", "semm"), ("valid", "valid")):
            n += _write(getattr(sc, field), t0, u[key])
        n += _write(a.candidate, t0, u["cand"])
        n += _write(a.needs_alpha, t0, u["needs_alpha"])
        n += _write(a.cluster_lo, c0, u["lo"])
        n += _write(a.cluster_hi, c0, u["hi"])
        n += _write(a.tri_attr, t0, u["attr"])
        n += _write(a.cluster_lo_alpha, c0, u["lo_a"])
        n += _write(a.cluster_hi_alpha, c0, u["hi_a"])
        for w, key in ((a.woop_w, "w"), (a.woop_w_shadow, "w_shadow"),
                       (a.woop_w_alpha, "w_alpha")):
            n += _write_table(w, 3 * t0, u[key])
        _rewrite_derived(a)
    refresh_dynamic.h2d_bytes = n
    return la


refresh_dynamic.h2d_bytes = 0


def _rewrite_derived(a: AccelScene) -> None:
    """What the tracers keep on ``a``'s tables (woop.padded_bounds,
    woop.walk_boxes, dense.scene_table), made anew in place after the
    tables were written."""
    for owner in (a.cluster_lo, a.cluster_lo_alpha, a.cluster_lo_proxy, a.scene.v0):
        if owner is not None:
            woop.rewrite_cached(owner)


# the Woop tables of an accel: each carries its packed rows (woop.pack_table)
WOOP_TABLES = ("woop_w", "woop_w_shadow", "woop_w_alpha", "woop_w_proxy")


def _fields(a: AccelScene) -> list:
    """(name, value) of every field of ``a``, the scene's fields inlined."""
    return ([(f"scene.{k}", v) for k, v in zip(Scene._fields, a.scene)]
            + [(k, v) for k, v in zip(AccelScene._fields, a) if k != "scene"])


def _layout(a: AccelScene) -> list:
    """``a``'s structure: each field None, or its shape, dtype, device and
    the first field it is the same tensor as (the shadow table is
    ``woop_w`` where it zeroes nothing)."""
    fields = _fields(a)
    first = lambda v: next(k for k, x in fields if x is v)
    return [(k, None if v is None else (tuple(v.shape), v.dtype, v.device, first(v)))
            for k, v in fields]


def write_accel(dst: AccelScene, src: AccelScene) -> AccelScene:
    """Write every table of ``src`` into ``dst``'s, in place, so that a
    frame compiled on ``dst`` (renderer.compile_frame) renders ``src``: the
    tensors of the accel, the packed rows ``rows4`` of each Woop table (an
    attribute, which capture.tree_map does not carry, so written here by
    name) and what the tracers derived and kept from the tables
    (:func:`_rewrite_derived`). A preset whose content moves builds a new
    accel each frame (``build_accel``, the JAX package's triangle order)
    and writes it into the one its frame was compiled on. Raises
    ValueError where the two differ in structure (a table present in one
    and None in the other, another shape, dtype or device, a table that
    is another table in one and not in the other). Reads no device value.
    Returns ``dst``."""
    want, got = _layout(dst), _layout(src)
    if want != got:
        diff = [f"{k}: {a} != {b}" for (k, a), (_, b) in zip(want, got) if a != b]
        raise ValueError("write_accel: the accels differ in structure, which a compiled frame "
                         f"cannot follow: {diff}")
    for (_, d), (_, s) in zip(_fields(dst), _fields(src)):
        if d is not None and d is not s:
            d.copy_(s)
    for k in WOOP_TABLES:
        d, s = getattr(dst, k), getattr(src, k)
        if d is not None and d is not s:
            woop.packed_rows(d).copy_(woop.packed_rows(s))
    _rewrite_derived(dst)
    return dst


def scene_features(scene: Scene, uniforms=None, atlas=None) -> SceneFeatures:
    """Derive static SceneFeatures from host scene data (with the atlas,
    ``has_alpha_tris`` is exact; without it, conservatively True)."""
    flags = _np(scene.flags)
    valid = _np(scene.valid)
    warp = (
        (flags >= materials.WARP_FLAG_MIN)
        & (flags <= materials.WARP_FLAG_MAX)
        & valid
    ).any()
    sky_mode = "none"
    if uniforms is not None:
        if int(_np(uniforms.sky_classic)[0]) >= 0:
            sky_mode = "classic"
        elif int(_np(uniforms.sky_cube).max()) >= 0:
            sky_mode = "cubemap"
    emis = (
        (flags == materials.MAT_FLAGS_SPRITE)
        | (flags == materials.MAT_FLAGS_TELE)
        | (flags == materials.MAT_FLAGS_WATERFALL)
    ) & valid
    has_alpha_tris = True
    if atlas is not None:
        alpha = _np(scene.alpha)
        texnum = _np(scene.texnum)
        flag_opaque = (flags > 0) & (flags < 7)
        has_override = alpha >= 0.0
        tex_has_alpha = texture_alpha_flags(atlas)[np.clip(texnum, 0, None)]
        has_alpha_tris = bool(
            (valid & ~flag_opaque & ~has_override & tex_has_alpha).any()
        )
    return SceneFeatures(
        sky_mode=sky_mode,
        has_alpha_tris=has_alpha_tris,
        has_fb=bool(((_np(scene.fb_texnum) > 0) & valid).any()),
        has_gloss=bool(((_np(scene.gloss_texnum) > 0) & valid).any()),
        has_warp=bool(warp),
        has_emissive_tex=bool(emis.any()),
        has_normalmap=bool(((_np(scene.normal_texnum) > 0) & valid).any()),
    )
