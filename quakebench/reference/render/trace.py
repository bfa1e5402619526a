"""Full trace + hit shading: the heart of every integrator.

Port of merian_quake_tpu/render/trace.py (the reference's
raytrace.glsl ``trace_ray``): nearest accepted hit via the accel layer,
fog transmittance, procedural sky (sun glow + classic two-layer sky or
cubemap) on miss/sky hits, Quake UV warp, material decode, motion
vectors from previous-frame vertices. Per-hit attributes come from one
gather of ``accel.tri_attr``; the static SceneFeatures flags skip
unused material paths.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel.build import AccelScene
from ..accel.intersect import HitRecord, trace_nearest
from ..models import atlas as atlas_mod
from ..models import materials
from ..models.types import SceneFeatures, TextureAtlas, Uniforms
from ..ops import color as color_ops
from ..ops import linalg, transmittance as trans_ops, vmf
from .hit import Hit

T_MAX = materials.T_MAX

# tri_attr column layout (accel/build.py)
_A_V0, _A_V1, _A_V2 = slice(0, 3), slice(3, 6), slice(6, 9)
_A_PV0, _A_PV1, _A_PV2 = slice(9, 12), slice(12, 15), slice(15, 18)
_A_ST = slice(18, 24)
_A_TEX, _A_FB, _A_GLOSS, _A_FLAGS = 24, 25, 26, 27
_A_SOLID_ALB, _A_SOLID_EMM = slice(28, 31), slice(31, 34)
_A_NORMAL = 34
_A_TEXEL_DENSITY = 35

_SKY_BAKE_N = 256
_CUBE_BAKE_N = 512

ALL_FEATURES = SceneFeatures(
    sky_mode="cubemap", has_fb=True, has_gloss=True, has_warp=True,
    has_emissive_tex=True, has_normalmap=True,
)


def _classic_sky(atlas: TextureAtlas, uniforms: Uniforms, w):
    """Classic scrolling two-layer Quake sky (raytrace.glsl:36-43).

    The color depends on q = w.xy/|w.z| alone and is periodic in q with
    period 1, so it is baked onto a 256² grid over one period and each
    ray does one lookup.
    """
    dev = w.device
    t = uniforms.cl_time * 0.12
    nb = _SKY_BAKE_N
    qx = (torch.arange(nb, dtype=torch.float32, device=dev) + 0.5) / nb
    qg = torch.stack(torch.meshgrid(qx, qx, indexing="ij"), dim=-1).reshape(-1, 2)
    st = 0.5 + qg
    bck = atlas_mod.sample_bilinear(atlas, uniforms.sky_classic[0], st + 0.5 * t)
    fnt = atlas_mod.sample_bilinear(atlas, uniforms.sky_classic[1], st + t)
    tex = bck[..., :3] * (1.0 - fnt[..., 3:4]) + fnt[..., :3] * fnt[..., 3:4]
    baked = 10.0 * (torch.exp2(3.5 * tex) - 1.0)  # (nb², 3)

    q = torch.stack([w[..., 0], w[..., 1]], dim=-1) / torch.clamp_min(
        w[..., 2].abs(), 1e-4
    )[..., None]
    qf = q - torch.floor(q)
    xi = torch.clamp((qf[..., 0] * nb).to(torch.int64), 0, nb - 1)
    yi = torch.clamp((qf[..., 1] * nb).to(torch.int64), 0, nb - 1)
    return baked[xi * nb + yi]


def _cubemap_sky_baked(atlas: TextureAtlas, uniforms: Uniforms, w):
    """Cubemap sky via a per-frame 512² octahedral bake (one lookup/ray)."""
    from ..ops import octahedral

    nb = _CUBE_BAKE_N
    gx = (torch.arange(nb, dtype=torch.float32, device=w.device) + 0.5) / nb * 2.0 - 1.0
    uv = torch.stack(torch.meshgrid(gx, gx, indexing="ij"), dim=-1).reshape(-1, 2)
    baked = _cubemap_sky(atlas, uniforms, octahedral.from_oct(uv))  # (nb², 3)

    e = octahedral.to_oct(w)
    xi = torch.clamp(((e[..., 0] * 0.5 + 0.5) * nb).to(torch.int64), 0, nb - 1)
    yi = torch.clamp(((e[..., 1] * 0.5 + 0.5) * nb).to(torch.int64), 0, nb - 1)
    return baked[xi * nb + yi]


def _cubemap_sky(atlas: TextureAtlas, uniforms: Uniforms, w):
    """Six-face skybox sample (raytrace.glsl:45-59)."""
    ax, ay, az = w[..., 0].abs(), w[..., 1].abs(), w[..., 2].abs()
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    wh = torch.where
    side_x = wh(x >= 0, 0, 1)
    side_y = wh(y >= 0, 2, 3)
    side_z = wh(z >= 0, 4, 5)
    side = wh((ax >= ay) & (ax >= az), side_x, wh(ay >= az, side_y, side_z))
    su = wh(side <= 1, wh(side == 0, -y, y), wh(side == 2, x, wh(side == 3, -x, -y)))
    sv = wh(side == 4, x, wh(side == 5, -x, -z))
    den = torch.clamp_min(wh(side <= 1, ax, wh(side <= 3, ay, az)), 1e-4)
    st = 0.5 + 0.5 * torch.stack([su, sv], -1) / den[..., None]
    sc = uniforms.sky_cube
    texnum = wh(
        side <= 1, wh(side == 0, sc[0], sc[1]),
        wh(side <= 3, wh(side == 2, sc[2], sc[3]), wh(side == 4, sc[4], sc[5])),
    )
    col = atlas_mod.sample_bilinear(atlas, torch.clamp_min(texnum, 0), st)[..., :3]
    return wh((texnum >= 0)[..., None], col, 0.0)


def get_sky(atlas: TextureAtlas, uniforms: Uniforms, w, sky_mode: str = "cubemap"):
    """Sky radiance for direction w (raytrace.glsl get_sky, :25-60).

    'classic' REPLACES the sun glow, 'cubemap' ADDS to it, 'none' = sun.
    """
    if sky_mode == "classic":
        return _classic_sky(atlas, uniforms, w)
    sun_glow = 0.5 * torch.pow(0.5 * (1.0 + linalg.dot(uniforms.sun_w, w)), 4.0)
    sun_disc = 5.0 * vmf.pdf(w, uniforms.sun_w, 3000.0)
    sun_color = torch.clamp_max(uniforms.sun_color, materials.MAX_SUN_COLOR)
    emm = (sun_glow + sun_disc)[..., None] * sun_color
    if sky_mode == "cubemap":
        return emm + _cubemap_sky_baked(atlas, uniforms, w)
    return emm


def _warp_uv(uv, cl_time, flags):
    """Quake turbulent texture warp for lava/slime/tele/water + waves."""
    warp = (flags >= materials.WARP_FLAG_MIN) & (flags <= materials.WARP_FLAG_MAX)
    swap = uv.flip(-1)
    warped = uv + 0.125 * torch.sin(2.0 * torch.pi * swap + cl_time)
    water = flags == materials.MAT_FLAGS_WATER
    waves = 0.05 * torch.sin(4.0 * torch.pi * swap + 1.7 * cl_time)
    warped = warped + torch.where(water[..., None], waves, 0.0)
    return torch.where(warp[..., None], warped, uv)


class TraceResult(NamedTuple):
    throughput: torch.Tensor  # f32[N, 3] medium transmittance along segment
    contribution: torch.Tensor  # f32[N, 3] emission found (× throughput)
    hit: Hit
    hitrec: HitRecord
    flags: torch.Tensor  # i32[N] material flags at the hit (NONE on miss)
    t: torch.Tensor  # f32[N] ray parameter of the hit (T_MAX on sky/miss)


def trace_ray(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    pos,
    wi,
    bilinear: bool = False,
    pixel_cone=None,
    sort_rays: bool = False,
    features: SceneFeatures = ALL_FEATURES,
    active=None,
    schedule=None,
) -> TraceResult:
    """Trace from ``pos`` along ``wi`` and shade the hit.

    ``features`` skips unused material paths (the all-on default is
    always correct). ``pixel_cone`` (tan of the per-pixel angular
    radius) enables ray-cone mip selection on the albedo/emission
    fetches. ``active`` (bool[N] or None): dead rays trace with
    t_max = -1 and uniformly miss. ``schedule``: the card's trace schedule
    (accel.woop.TraceSchedule; None: the default routes).
    """
    alpha_tex = atlas if features.has_alpha_tris else None
    t_max = T_MAX if active is None else torch.where(active, T_MAX, -1.0)
    hr = trace_nearest(accel, alpha_tex, pos, wi, 0.0, t_max, sort_rays=sort_rays,
                       schedule=schedule)
    n = pos.shape[0]
    tri = torch.clamp_min(hr.tri, 0).long()
    t_hit = torch.where(hr.hit, hr.t, T_MAX)

    throughput = trans_ops.transmittance(
        t_hit, uniforms.mu_t, uniforms.volume_max_t
    )[..., None].expand(n, 3)

    # ---- ONE packed attribute gather ----
    attr = accel.tri_attr[tri]  # (N, 40)
    flags = torch.where(hr.hit, attr[:, _A_FLAGS].to(torch.int32), 0)
    is_sky = ~hr.hit | (flags == materials.MAT_FLAGS_SKY)

    v0, v1, v2 = attr[:, _A_V0], attr[:, _A_V1], attr[:, _A_V2]
    w0 = (1.0 - hr.u - hr.v)[..., None]
    wu = hr.u[..., None]
    wv = hr.v[..., None]
    hit_pos = v0 * w0 + v1 * wu + v2 * wv
    prev_pos = attr[:, _A_PV0] * w0 + attr[:, _A_PV1] * wu + attr[:, _A_PV2] * wv
    geo_n = linalg.normalize(linalg.cross(v2 - v0, v1 - v0))

    st = attr[:, _A_ST].reshape(n, 3, 2)
    uv = st[:, 0] * w0 + st[:, 1] * wu + st[:, 2] * wv
    if features.has_warp:
        uv = _warp_uv(uv, uniforms.cl_time, flags)

    texnum = attr[:, _A_TEX].to(torch.int32)
    use_mips = pixel_cone is not None and atlas.num_levels > 1
    if use_mips:
        cos_i = linalg.dot(geo_n, wi).abs()
        footprint = (
            t_hit * pixel_cone * attr[:, _A_TEXEL_DENSITY]
            / torch.clamp_min(cos_i, 0.1)
        )
        lod = torch.log2(torch.clamp_min(footprint, 1.0))
        albedo_tex = atlas_mod.sample_mip(atlas, texnum, uv, lod)[..., :3]
    else:
        albedo_tex = atlas_mod.sample(atlas, texnum, uv, bilinear=bilinear)[..., :3]

    # ---- tangent-space normal maps (brush models, raytrace.glsl:249-274) ----
    normal = geo_n
    if features.has_normalmap:
        nm_texnum = attr[:, _A_NORMAL].to(torch.int32)
        tn = (
            atlas_mod.sample(atlas, torch.clamp_min(nm_texnum, 0), uv, bilinear=False)[..., :3]
            - 0.5
        ) * 2.0
        dudv0 = v2 - v0
        dudv1 = v1 - v0
        sd0 = st[:, 2] - st[:, 0]
        sd1 = st[:, 1] - st[:, 0]
        st_det = sd0[:, 0] * sd1[:, 1] - sd1[:, 0] * sd0[:, 1]
        ok_det = st_det.abs() > 1e-8
        inv_det = 1.0 / torch.where(ok_det, st_det, 1.0)
        du = linalg.normalize(
            (sd1[:, 1:2] * dudv0 - sd0[:, 1:2] * dudv1) * inv_det[:, None]
        )
        dv = -linalg.normalize(
            (-sd1[:, 0:1] * dudv0 + sd0[:, 0:1] * dudv1) * inv_det[:, None]
        )
        du = torch.where(ok_det[:, None], du, dudv0)
        dv = torch.where(ok_det[:, None], dv, dudv1)
        perturbed = linalg.normalize(
            du * tn[:, 0:1] + dv * tn[:, 1:2] + geo_n * tn[:, 2:3]
        )
        # Keller et al. [2017] reflection workaround
        r = linalg.reflect(wi, perturbed)
        below = linalg.dot(r, geo_n) < 0.0
        fixed = linalg.normalize(
            -wi + linalg.normalize(r - geo_n * linalg.dot(geo_n, r)[..., None])
        )
        perturbed = torch.where(below[:, None], fixed, perturbed)
        normal = torch.where((nm_texnum > 0)[:, None], perturbed, geo_n)

    # ---- material decode ----
    roughness = torch.where(
        flags == materials.MAT_FLAGS_WATER,
        materials.WATER_ROUGHNESS,
        materials.DEFAULT_ROUGHNESS,
    )
    if features.has_gloss:
        gloss_texnum = attr[:, _A_GLOSS].to(torch.int32)
        gloss = atlas_mod.sample(
            atlas, torch.clamp_min(gloss_texnum, 0), uv, bilinear=False
        )[..., 0]
        roughness = torch.where(gloss_texnum > 0, gloss, roughness)

    solid = flags == materials.MAT_FLAGS_SOLID
    waterfall = flags == materials.MAT_FLAGS_WATERFALL
    sprite_tele = (flags == materials.MAT_FLAGS_SPRITE) | (
        flags == materials.MAT_FLAGS_TELE
    )

    albedo = torch.where(solid[..., None], attr[:, _A_SOLID_ALB], albedo_tex)
    emission = torch.where(solid[..., None], attr[:, _A_SOLID_EMM], 0.0)
    if features.has_emissive_tex:
        boosted = color_ops.ldr_to_hdr(albedo_tex)
        albedo = torch.where(sprite_tele[..., None], boosted, albedo)
        emission = torch.where(waterfall[..., None], albedo_tex, emission)
        emission = torch.where(sprite_tele[..., None], boosted, emission)
    if features.has_fb:
        fb_texnum = attr[:, _A_FB].to(torch.int32)
        fb_tex = torch.clamp_min(fb_texnum, 0)
        if use_mips:
            fb_col = atlas_mod.sample_mip(atlas, fb_tex, uv, lod)[..., :3]
        else:
            fb_col = atlas_mod.sample(atlas, fb_tex, uv, bilinear=bilinear)[..., :3]
        fb_emission = color_ops.ldr_to_hdr(fb_col)
        default_mat = ~(solid | waterfall | sprite_tele | is_sky)
        has_fb = default_mat & (fb_texnum > 0) & (fb_emission.amax(-1) > 0.0)
        emission = torch.where(has_fb[..., None], fb_emission, emission)
        albedo = torch.where(has_fb[..., None], fb_emission, albedo)

    # ---- sky ----
    sky_col = get_sky(atlas, uniforms, wi, sky_mode=features.sky_mode)
    albedo = torch.where(is_sky[..., None], sky_col, albedo)
    emission = torch.where(is_sky[..., None], sky_col, emission)
    sky_pos = pos + wi * T_MAX
    hit_pos = torch.where(is_sky[..., None], sky_pos, hit_pos)
    prev_pos = torch.where(is_sky[..., None], sky_pos, prev_pos)
    normal = torch.where(is_sky[..., None], -wi, normal)
    geo_n = torch.where(is_sky[..., None], -wi, geo_n)

    hit = Hit(
        pos=hit_pos,
        prev_pos=prev_pos,
        wi=wi,
        normal=normal,
        geo_normal=geo_n,
        albedo=albedo,
        roughness=roughness,
    )
    return TraceResult(
        throughput=throughput,
        contribution=throughput * emission,
        hit=hit,
        hitrec=hr,
        flags=torch.where(is_sky & hr.hit, materials.MAT_FLAGS_SKY, flags),
        t=torch.where(is_sky, T_MAX, t_hit),
    )
