"""The reference's scene tables, worked out from the scene's triangles.

A frozen copy of the port's plain numpy build (``accel/build.py`` with
``native=False``): the acceptance classes, the cluster-aligned
median-split triangle order, the shading attributes ``tri_attr`` and
the live game's dynamic suffix (``dynamic_rows``), with the Woop rows
and cluster boxes of that suffix (``woop.build_woop``), which the
benchmark holds the program's refreshed tables to. The triangle order is
the port's, so that a triangle index means the same triangle on both
sides and the program's frame state (which holds such indices) can be
continued here. The reference traces with its own tables
(``intersect.py``); it has no Woop table of the whole scene.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import materials
from ..models.types import CLUSTER_SIZE, Scene, SceneFeatures, TextureAtlas


class AccelScene(NamedTuple):
    """Scene + what the reference's trace and shading read (leading dim T,
    the port's triangle order). ``precision`` "bf16" rounds every hit's
    (t, u, v) to bfloat16: the control of the comparison."""

    scene: Scene
    candidate: torch.Tensor  # bool[T] participates in intersection
    needs_alpha: torch.Tensor  # bool[T] a committed hit needs the texture alpha test
    tri_attr: torch.Tensor  # f32[T, 40] packed shading attributes
    precision: str = "fp32"


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
    """Cluster-aligned recursive median-split triangle order: candidates
    first, then alpha-only valid triangles, then padding."""
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
    lo = +1e30, hi = -1e30."""
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


def build_woop(v0, v1, v2, candidate, chunk: int = CLUSTER_SIZE):
    """The Woop affine rows (w[3T, 8], updated candidate) the port's
    trace kernels read: per CLUSTER_SIZE chunk the chunk's row-0 vectors,
    then row-1, then row-2, each [A | b] in columns 0-3; non-candidate and
    degenerate triangles all zero."""
    v0 = np.asarray(v0, np.float64)
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    m = np.stack([e1, e2, n], axis=-1)
    det = np.linalg.det(m)
    ok = np.abs(det) > 1e-12
    cand = np.asarray(candidate, bool) & ok
    m_safe = np.where(ok[:, None, None], m, np.eye(3)[None])
    inv = np.linalg.inv(m_safe)
    b = -np.einsum("tij,tj->ti", inv, v0)
    t = v0.shape[0]
    c = chunk
    rows = np.concatenate([inv, b[:, :, None]], axis=2).astype(np.float32)
    rows = np.where(cand[:, None, None], rows, 0.0)
    blocks = rows.reshape(t // c, c, 3, 4).transpose(0, 2, 1, 3)
    w = np.zeros((3 * t, 8), np.float32)
    w[:, :4] = blocks.reshape(3 * t, 4)
    return w, cand


def bake_candidacy(w: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """Zero the w rows of non-candidate triangles (layout-aware)."""
    t = cand.shape[0]
    c = CLUSTER_SIZE
    mask = np.broadcast_to(
        np.asarray(cand, bool).reshape(t // c, 1, c), (t // c, 3, c)
    ).reshape(3 * t)
    return np.where(mask[:, None], w, 0.0).astype(np.float32)


def _tri_attr(v0, v1, v2, pv0, pv1, pv2, st, texnum, fb, gloss, flags, salb, semm, normal,
              tex_px):
    T = v0.shape[0]
    attr = np.zeros((T, 40), np.float32)
    attr[:, 0:3], attr[:, 3:6], attr[:, 6:9] = v0, v1, v2
    attr[:, 9:12], attr[:, 12:15], attr[:, 15:18] = pv0, pv1, pv2
    attr[:, 18:24] = st.reshape(T, 6)
    attr[:, 24] = texnum
    attr[:, 25] = fb
    if gloss is not None:
        attr[:, 26] = gloss
    attr[:, 27] = flags
    attr[:, 28:31] = salb
    attr[:, 31:34] = semm
    if normal is not None:
        attr[:, 34] = normal
    # texel density (texels per world unit) for ray-cone mip selection
    sd0 = st[:, 1] - st[:, 0]
    sd1 = st[:, 2] - st[:, 0]
    uv_area = 0.5 * np.abs(sd0[:, 0] * sd1[:, 1] - sd0[:, 1] * sd1[:, 0])
    w_area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    attr[:, 35] = np.sqrt(uv_area * tex_px / np.maximum(w_area, 1e-9)).astype(np.float32)
    return attr


def build_accel(scene: Scene, atlas: TextureAtlas, device) -> AccelScene:
    """The reference's tables of a static scene (host arrays or tensors),
    on ``device``."""
    host = [_np(a) for a in scene]
    sc = Scene(*host)
    valid, flags, alpha, texnum = sc.valid, sc.flags, sc.alpha, sc.texnum
    flag_opaque = (flags > 0) & (flags < 7)
    has_override = alpha >= 0.0
    override_accept = has_override & (alpha >= materials.ALPHA_THRESHOLD)
    override_reject = has_override & (alpha < materials.ALPHA_THRESHOLD)
    tex_has_alpha = texture_alpha_flags(atlas)[np.clip(texnum, 0, None)]
    needs_alpha = valid & ~flag_opaque & ~has_override & tex_has_alpha
    candidate = valid & ~override_reject & (flag_opaque | override_accept | ~has_override)
    perm = _median_split_perm(sc.v0, sc.v1, sc.v2, candidate, valid)
    sc = Scene(*[a[perm] for a in host])
    tdim = _np(atlas.table)[np.clip(sc.texnum, 0, None)]
    tex_px = np.maximum(tdim[:, 2] * tdim[:, 3], 1).astype(np.float64)
    attr = _tri_attr(sc.v0, sc.v1, sc.v2, sc.pv0, sc.pv1, sc.pv2, sc.st, sc.texnum,
                     sc.fb_texnum, sc.gloss_texnum, sc.flags, sc.solid_albedo,
                     sc.solid_emission, sc.normal_texnum, tex_px)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return AccelScene(scene=Scene(*[dev(a) for a in sc]), candidate=dev(candidate[perm]),
                      needs_alpha=dev(needs_alpha[perm]), tri_attr=dev(attr))


class LiveAccel(NamedTuple):
    """The live game's reference tables: the static build, then a dynamic
    suffix of ``dyn_cap`` rows that :func:`apply_dynamic` writes a frame."""

    accel: AccelScene
    n_static: int
    dyn_cap: int
    tex_alpha: np.ndarray  # bool[MAX_TEX]
    tex_px: np.ndarray  # f64[MAX_TEX] texel count


def build_accel_live(scene: Scene, atlas: TextureAtlas, dyn_cap: int, device) -> LiveAccel:
    acc = build_accel(scene, atlas, device)
    dyn_cap = -(-dyn_cap // CLUSTER_SIZE) * CLUSTER_SIZE
    grow = lambda x, fill=0: torch.cat([x, x.new_full((dyn_cap,) + tuple(x.shape[1:]), fill)])
    sc = Scene(*[grow(x, -1.0 if k == "alpha" else False if k == "valid" else 0)
                 for k, x in zip(Scene._fields, acc.scene)])
    table = _np(atlas.table)
    return LiveAccel(
        accel=acc._replace(scene=sc, candidate=grow(acc.candidate, False),
                           needs_alpha=grow(acc.needs_alpha, False), tri_attr=grow(acc.tri_attr)),
        n_static=acc.scene.num_tris, dyn_cap=dyn_cap, tex_alpha=texture_alpha_flags(atlas),
        tex_px=np.maximum(table[:, 2] * table[:, 3], 1).astype(np.float64))


def dynamic_rows(la: LiveAccel, dyn: dict) -> dict:
    """The dynamic suffix's rows of every table, host arrays, from the game
    step's dynamic block: the scene fields, the candidacy, the cluster
    boxes, the Woop rows of the nearest, shadow and alpha-only tables and
    the shading attributes."""
    cap = la.dyn_cap
    pad = cap - dyn["v"].shape[0]
    pd = ((lambda a: np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]))
          if pad else (lambda a: a))
    v0, v1, v2 = pd(dyn["v"][:, 0]), pd(dyn["v"][:, 1]), pd(dyn["v"][:, 2])
    pv0, pv1, pv2 = pd(dyn["prev"][:, 0]), pd(dyn["prev"][:, 1]), pd(dyn["prev"][:, 2])
    valid, flags, tex, fb = pd(dyn["valid"]), pd(dyn["flags"]), pd(dyn["tex"]), pd(dyn["fb"])
    uv, salb, semm = pd(dyn["uv"]), pd(dyn["salb"]), pd(dyn["semm"])
    flag_opaque = (flags > 0) & (flags < 7)
    needs_alpha = valid & ~flag_opaque & la.tex_alpha[np.clip(tex, 0, None)]
    w, cand = build_woop(v0, v1, v2, valid)
    w = bake_candidacy(w, cand)
    lo, hi = cluster_aabbs(v0, v1, v2, cand)
    sky = flags == materials.MAT_FLAGS_SKY
    alpha_cand = cand & needs_alpha
    lo_a, hi_a = cluster_aabbs(v0, v1, v2, alpha_cand)
    tpx = la.tex_px[np.clip(tex, 0, len(la.tex_px) - 1)]
    attr = _tri_attr(v0, v1, v2, pv0, pv1, pv2, uv, tex, fb, None, flags, salb, semm, None, tpx)
    return dict(
        v0=v0, v1=v1, v2=v2, pv0=pv0, pv1=pv1, pv2=pv2, st=uv, texnum=tex, fb=fb, flags=flags,
        salb=salb, semm=semm, valid=valid, cand=cand, needs_alpha=needs_alpha, lo=lo, hi=hi,
        lo_a=lo_a, hi_a=hi_a, w=w, w_shadow=bake_candidacy(w, cand & ~sky & ~needs_alpha),
        w_alpha=bake_candidacy(w, alpha_cand), attr=attr,
    )


# the live scene's fields that the dynamic block writes, with its keys
DYN_SCENE_FIELDS = (("v0", "v0"), ("v1", "v1"), ("v2", "v2"), ("pv0", "pv0"), ("pv1", "pv1"),
                    ("pv2", "pv2"), ("st", "st"), ("texnum", "texnum"), ("fb_texnum", "fb"),
                    ("flags", "flags"), ("solid_albedo", "salb"), ("solid_emission", "semm"),
                    ("valid", "valid"))


def apply_dynamic(la: LiveAccel, rows: dict) -> LiveAccel:
    """Write :func:`dynamic_rows`' suffix into the reference's tables."""
    t0 = la.n_static
    a = la.accel
    put = lambda dst, src: dst[t0:t0 + src.shape[0]].copy_(
        torch.from_numpy(np.ascontiguousarray(src)).to(dst.dtype))
    for field, key in DYN_SCENE_FIELDS:
        put(getattr(a.scene, field), rows[key])
    put(a.candidate, rows["cand"])
    put(a.needs_alpha, rows["needs_alpha"])
    put(a.tri_attr, rows["attr"])
    return la


def scene_features(scene: Scene, uniforms=None, atlas=None) -> SceneFeatures:
    """Static SceneFeatures from host scene data."""
    flags = _np(scene.flags)
    valid = _np(scene.valid)
    warp = ((flags >= materials.WARP_FLAG_MIN) & (flags <= materials.WARP_FLAG_MAX)
            & valid).any()
    sky_mode = "none"
    if uniforms is not None:
        if int(_np(uniforms.sky_classic)[0]) >= 0:
            sky_mode = "classic"
        elif int(_np(uniforms.sky_cube).max()) >= 0:
            sky_mode = "cubemap"
    emis = ((flags == materials.MAT_FLAGS_SPRITE) | (flags == materials.MAT_FLAGS_TELE)
            | (flags == materials.MAT_FLAGS_WATERFALL)) & valid
    has_alpha_tris = True
    if atlas is not None:
        alpha = _np(scene.alpha)
        texnum = _np(scene.texnum)
        flag_opaque = (flags > 0) & (flags < 7)
        has_override = alpha >= 0.0
        tex_has_alpha = texture_alpha_flags(atlas)[np.clip(texnum, 0, None)]
        has_alpha_tris = bool((valid & ~flag_opaque & ~has_override & tex_has_alpha).any())
    return SceneFeatures(
        sky_mode=sky_mode,
        has_alpha_tris=has_alpha_tris,
        has_fb=bool(((_np(scene.fb_texnum) > 0) & valid).any()),
        has_gloss=bool(((_np(scene.gloss_texnum) > 0) & valid).any()),
        has_warp=bool(warp),
        has_emissive_tex=bool(emis.any()),
        has_normalmap=bool(((_np(scene.normal_texnum) > 0) & valid).any()),
    )
