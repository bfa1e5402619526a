"""Host-side acceleration build: triangle classes + median-split clusters.

Port of merian_quake_tpu/accel/build.py::build_accel for the nearest-hit
path. The build runs in numpy on the host (the JAX package's numpy
fallbacks; its optional C++ helpers give the same tables up to f32
rounding of the Woop rows) and the tables move to the requested device
once:

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
  candidates.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import materials
from ..models.types import CLUSTER_SIZE, Scene, SceneFeatures, TextureAtlas
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


def build_accel(
    scene: Scene, atlas: TextureAtlas | None = None, device=None
) -> AccelScene:
    """Build the accel tables on the host; place them on ``device``
    (default: the scene's device)."""
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

    perm = _median_split_perm(sc.v0, sc.v1, sc.v2, candidate, valid)
    sc = Scene(*[a[perm] for a in host])
    candidate = candidate[perm]
    needs_alpha = needs_alpha[perm]
    v0, v1, v2 = sc.v0, sc.v1, sc.v2
    T = v0.shape[0]

    lo_c, hi_c = cluster_aabbs(v0, v1, v2, candidate)
    woop_w, _ = build_woop(v0, v1, v2, candidate)
    anyhit = _anyhit_tables(v0, v1, v2, sc.flags, candidate, needs_alpha, woop_w)

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


def _anyhit_tables(v0, v1, v2, flags, candidate, needs_alpha, woop_w) -> dict:
    """The shadow, alpha-only and proxy tables of K2 (host arrays; None
    where the scene has no such table). The shadow table *is* ``woop_w``
    when it zeroes nothing."""
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
        out["cluster_lo_alpha"], out["cluster_hi_alpha"] = cluster_aabbs(v0, v1, v2, alpha_cand)
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
        out["cluster_lo_proxy"], out["cluster_hi_proxy"] = cluster_aabbs(pv0, pv1, pv2, pcand)
    return out


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
