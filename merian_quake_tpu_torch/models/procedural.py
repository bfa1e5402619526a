"""Procedural test scenes.

Port of merian_quake_tpu/models/procedural.py: a closed Cornell-style
room, an outdoor court (sky, sun, water, an alpha-tested grate, optional
fog), a guiding scene with its light behind a slot, the map-scale city
and a furnace, with their texture helpers. The host build is numpy; the
bundle's tensors land on ``device``. Units and axes follow Quake: 1 unit
≈ 1 inch, +z up.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import materials
from .atlas import pack_textures
from .types import (
    Scene, TextureAtlas, Uniforms, build_scene_from_soup, default_uniforms,
)


class SceneBundle(NamedTuple):
    scene: Scene
    atlas: TextureAtlas
    uniforms: Uniforms


class _SoupBuilder:
    def __init__(self):
        self.v0, self.v1, self.v2 = [], [], []
        self.st = []
        self.texnum = []
        self.fb = []
        self.flags = []
        self.alpha = []
        self.solid_albedo = []
        self.solid_emission = []

    def tri(
        self,
        a,
        b,
        c,
        st=((0, 0), (1, 0), (1, 1)),
        texnum=0,
        fb=0,
        flags=0,
        alpha=-1.0,
        solid_albedo=(0, 0, 0),
        solid_emission=(0, 0, 0),
    ):
        self.v0.append(a)
        self.v1.append(b)
        self.v2.append(c)
        self.st.append(st)
        self.texnum.append(texnum)
        self.fb.append(fb)
        self.flags.append(flags)
        self.alpha.append(alpha)
        self.solid_albedo.append(solid_albedo)
        self.solid_emission.append(solid_emission)

    def quad(self, p, du, dv, uv_scale=(1.0, 1.0), **kw):
        """Quad at p spanned by du, dv; geometric normal = cross(du, dv).

        (Reference normal convention is n = cross(v2-v0, v1-v0),
        raytrace.glsl:221 — vertex order here is chosen so the quad
        normal comes out along du×dv.)
        """
        p = np.asarray(p, np.float64)
        du = np.asarray(du, np.float64)
        dv = np.asarray(dv, np.float64)
        su, sv = uv_scale
        a, b, c, d = p, p + du, p + du + dv, p + dv
        # v1=d, v2=b → n = cross(b-a, d-a) = cross(du, dv)
        self.tri(a, d, b, st=((0, 0), (0, sv), (su, 0)), **kw)
        self.tri(c, b, d, st=((su, sv), (su, 0), (0, sv)), **kw)

    def build(self, device="cuda") -> Scene:
        n = len(self.v0)
        return build_scene_from_soup(
            np.asarray(self.v0, np.float32).reshape(n, 3),
            np.asarray(self.v1, np.float32).reshape(n, 3),
            np.asarray(self.v2, np.float32).reshape(n, 3),
            st=np.asarray(self.st, np.float32).reshape(n, 3, 2),
            texnum=np.asarray(self.texnum, np.int32),
            fb_texnum=np.asarray(self.fb, np.int32),
            flags=np.asarray(self.flags, np.int32),
            alpha=np.asarray(self.alpha, np.float32),
            solid_albedo=np.asarray(self.solid_albedo, np.float32).reshape(n, 3),
            solid_emission=np.asarray(self.solid_emission, np.float32).reshape(n, 3),
            device=device,
        )


def _const_tex(rgb, size=8, alpha=255):
    t = np.zeros((size, size, 4), np.uint8)
    t[..., :3] = np.asarray(rgb, np.uint8)
    t[..., 3] = alpha
    return t


def _checker_tex(rgb_a, rgb_b, size=32, cells=4):
    t = np.zeros((size, size, 4), np.uint8)
    cs = size // cells
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx // cs) + (yy // cs)) % 2 == 0
    t[mask, :3] = rgb_a
    t[~mask, :3] = rgb_b
    t[..., 3] = 255
    return t


def _grate_tex(size=32):
    """Alpha-tested grate: opaque bars, transparent holes."""
    t = np.zeros((size, size, 4), np.uint8)
    t[..., :3] = 140
    bars = (np.arange(size) % 8) < 3
    opaque = bars[:, None] | bars[None, :]
    t[..., 3] = np.where(opaque, 255, 0)
    return t


def _sky_tex(size=64, seed=7):
    """Quake-ish sky layer: dark blue-purple base with brighter cloud
    blotches (values stay low — the classic-sky shader boosts them with
    10·(2^(3.5·tex)−1), raytrace.glsl:43)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    clouds = np.zeros((size, size))
    for octave in (4, 8, 16):
        base = rng.uniform(0, 1, (octave, octave))
        up = np.kron(base, np.ones((size // octave, size // octave)))
        clouds += up / octave * 4
    clouds = (clouds - clouds.min()) / (np.ptp(clouds) + 1e-9)
    t = np.zeros((size, size, 4), np.uint8)
    base_col = np.asarray([0.05, 0.04, 0.09])
    cloud_col = np.asarray([0.22, 0.20, 0.26])
    rgb = base_col + (cloud_col - base_col) * clouds[..., None]
    t[..., :3] = (rgb * 255).astype(np.uint8)
    t[..., 3] = (clouds > 0.55) * 255  # front layer alpha = clouds
    return t


def cornell_box(emission=16.0, device="cuda") -> SceneBundle:
    """Closed room, one ceiling area light, two blocks.

    Room interior: x,y in [0, 512], z in [0, 256]. Camera looks +x.
    """
    textures = [
        _const_tex((255, 255, 255), 1),  # 0: white dummy
        _const_tex((200, 200, 200)),  # 1: white walls
        _const_tex((200, 60, 50)),  # 2: red (left, y=512 side)
        _const_tex((60, 200, 70)),  # 3: green (right, y=0 side)
        _checker_tex((180, 180, 180), (90, 90, 90)),  # 4: floor
        _const_tex((150, 140, 130)),  # 5: blocks
    ]
    b = _SoupBuilder()
    X, Y, Z = 512.0, 512.0, 256.0
    uv = (4.0, 4.0)
    # normals must point INTO the room (quad normal = cross(du, dv))
    b.quad((0, 0, 0), (X, 0, 0), (0, Y, 0), uv_scale=uv, texnum=4)  # floor +z
    b.quad((0, 0, Z), (0, Y, 0), (X, 0, 0), uv_scale=uv, texnum=1)  # ceiling -z
    b.quad((X, 0, 0), (0, 0, Z), (0, Y, 0), uv_scale=uv, texnum=1)  # far wall -x
    b.quad((0, 0, 0), (0, Y, 0), (0, 0, Z), uv_scale=uv, texnum=1)  # near wall +x
    b.quad((0, Y, 0), (X, 0, 0), (0, 0, Z), uv_scale=uv, texnum=2)  # left -y
    b.quad((0, 0, 0), (0, 0, Z), (X, 0, 0), uv_scale=uv, texnum=3)  # right +y

    # ceiling light (solid emissive), slightly below the ceiling
    e = float(emission)
    b.quad(
        (192, 192, Z - 1), (0, 128, 0), (128, 0, 0),
        flags=materials.MAT_FLAGS_SOLID,
        solid_albedo=(0.8, 0.8, 0.8),
        solid_emission=(e, e, e),
    )

    def block(x0, y0, w, d, h, tex):
        # 5 visible faces, normals outward
        b.quad((x0, y0, h), (w, 0, 0), (0, d, 0), texnum=tex)  # top +z
        b.quad((x0, y0, 0), (0, 0, h), (0, d, 0), texnum=tex)  # -x
        b.quad((x0 + w, y0, 0), (0, d, 0), (0, 0, h), texnum=tex)  # +x
        b.quad((x0, y0, 0), (w, 0, 0), (0, 0, h), texnum=tex)  # -y
        b.quad((x0, y0 + d, 0), (0, 0, h), (w, 0, 0), texnum=tex)  # +y

    block(300, 290, 90, 90, 120, 5)
    block(260, 120, 80, 80, 60, 5)

    scene = b.build(device)
    atlas = pack_textures(textures, device=device)
    uniforms = default_uniforms(
        cam_x=(40.0, 256.0, 130.0),
        cam_w=(1.0, 0.0, 0.0),
        cam_u=(0.0, 0.0, 1.0),
        fov_deg=90.0,
        device=device,
    )
    return SceneBundle(scene, atlas, uniforms)


def outdoor_court(fog_mu_t=0.0, device="cuda") -> SceneBundle:
    """Open court with sky walls/ceiling, sun, water pool, alpha grate.

    Exercises: MAT_FLAGS_SKY + classic sky sampling + sun vMF glow,
    water UV warp + roughness, alpha-tested transparency, fullbright
    emission textures, optional fog.
    """
    textures = [
        _const_tex((255, 255, 255), 1),  # 0 dummy
        _checker_tex((170, 160, 150), (120, 110, 100)),  # 1 stone floor
        _const_tex((150, 150, 155)),  # 2 walls
        _grate_tex(),  # 3 alpha grate
        _const_tex((40, 70, 160)),  # 4 water
        _sky_tex(seed=3),  # 5 sky back layer
        _sky_tex(seed=9),  # 6 sky front (alpha) layer
        _const_tex((255, 240, 160)),  # 7 fullbright lamp texture
    ]
    b = _SoupBuilder()
    X, Y, Z = 1024.0, 768.0, 320.0
    SKY = materials.MAT_FLAGS_SKY
    b.quad((0, 0, 0), (X, 0, 0), (0, Y, 0), uv_scale=(8, 6), texnum=1)  # floor
    b.quad((0, 0, Z), (0, Y, 0), (X, 0, 0), texnum=5, flags=SKY)  # sky ceiling
    b.quad((X, 0, 0), (0, 0, Z), (0, Y, 0), uv_scale=(8, 3), texnum=2)  # far wall
    b.quad((0, 0, 0), (0, Y, 0), (0, 0, Z), texnum=5, flags=SKY)  # near: sky
    b.quad((0, Y, 0), (X, 0, 0), (0, 0, Z), uv_scale=(8, 3), texnum=2)  # left
    b.quad((0, 0, 0), (0, 0, Z), (X, 0, 0), texnum=5, flags=SKY)  # right: sky

    # water pool (warped UVs, roughness 0.4)
    b.quad(
        (300, 200, 8), (320, 0, 0), (0, 240, 0),
        uv_scale=(4, 3), texnum=4, flags=materials.MAT_FLAGS_WATER,
    )
    # two alpha-tested grates (one-sided, facing -x toward the camera)
    b.quad((640, 100, 0), (0, 0, 160), (0, 200, 0), uv_scale=(4, 3), texnum=3)
    b.quad((700, 100, 0), (0, 0, 160), (0, 200, 0), uv_scale=(4, 3), texnum=3)
    # fullbright lamp strip on the far wall
    b.quad((X - 1, 300, 200), (0, 0, 40), (0, 168, 0), texnum=7, fb=7)

    scene = b.build(device)
    atlas = pack_textures(textures, device=device)
    uniforms = default_uniforms(
        cam_x=(80.0, 384.0, 140.0),
        cam_w=(1.0, 0.0, 0.0),
        cam_u=(0.0, 0.0, 1.0),
        fov_deg=100.0,
        mu_t=fog_mu_t,
        mu_s=(fog_mu_t * 0.7,) * 3,
        sun_w=(0.5, 0.2, 0.84),
        sun_color=(9.0, 8.0, 6.5),
        sky_classic=(5, 6),
        device=device,
    )
    return SceneBundle(scene, atlas, uniforms)


def alcove(emission=200.0, device="cuda") -> SceneBundle:
    """Hard guiding scene: the only light sits in a side pocket behind a
    narrow slot — BSDF sampling rarely finds it, path guiding should.

    Main room x∈[0,512]; pocket x∈[512,640] behind the x=512 wall with a
    slot opening y∈[224,288], z∈[64,192].
    """
    textures = [
        _const_tex((255, 255, 255), 1),  # 0 dummy
        _const_tex((190, 190, 190)),  # 1 walls
        _checker_tex((180, 180, 180), (90, 90, 90)),  # 2 floor
    ]
    b = _SoupBuilder()
    X, Y, Z = 512.0, 512.0, 256.0
    PX = 640.0  # pocket far x
    sy0, sy1, sz0, sz1 = 224.0, 288.0, 64.0, 192.0
    uv = (4.0, 4.0)
    b.quad((0, 0, 0), (X, 0, 0), (0, Y, 0), uv_scale=uv, texnum=2)  # floor
    b.quad((0, 0, Z), (0, Y, 0), (X, 0, 0), uv_scale=uv, texnum=1)  # ceiling
    b.quad((0, 0, 0), (0, Y, 0), (0, 0, Z), uv_scale=uv, texnum=1)  # near +x
    b.quad((0, Y, 0), (X, 0, 0), (0, 0, Z), uv_scale=uv, texnum=1)  # left -y
    b.quad((0, 0, 0), (0, 0, Z), (X, 0, 0), uv_scale=uv, texnum=1)  # right +y

    # x=512 wall facing -x with slot hole (4 quads around the slot)
    def wallx(y0, y1, z0, z1):
        if y1 > y0 and z1 > z0:
            b.quad((X, y0, z0), (0, 0, z1 - z0), (0, y1 - y0, 0), texnum=1)

    wallx(0.0, sy0, 0.0, Z)
    wallx(sy1, Y, 0.0, Z)
    wallx(sy0, sy1, 0.0, sz0)
    wallx(sy0, sy1, sz1, Z)
    # pocket interior (faces point into the pocket)
    b.quad((X, sy0, sz0), (0, sy1 - sy0, 0), (PX - X, 0, 0), texnum=1)  # floor
    b.quad((X, sy0, sz1), (PX - X, 0, 0), (0, sy1 - sy0, 0), texnum=1)  # ceiling
    b.quad((PX, sy0, sz0), (0, 0, sz1 - sz0), (0, sy1 - sy0, 0), texnum=1)  # back
    b.quad((X, sy0, sz0), (PX - X, 0, 0), (0, 0, sz1 - sz0), texnum=1)  # side -y
    b.quad((X, sy1, sz0), (0, 0, sz1 - sz0), (PX - X, 0, 0), texnum=1)  # side +y
    # bright light panel on the pocket back wall
    e = float(emission)
    b.quad(
        (PX - 1, sy0 + 8, sz0 + 8),
        (0, 0, sz1 - sz0 - 16),
        (0, sy1 - sy0 - 16, 0),
        flags=materials.MAT_FLAGS_SOLID,
        solid_albedo=(0.8, 0.8, 0.8),
        solid_emission=(e, e, e),
    )
    scene = b.build(device)
    atlas = pack_textures(textures, device=device)
    uniforms = default_uniforms(
        cam_x=(60.0, 256.0, 128.0),
        cam_w=(1.0, 0.0, 0.0),
        cam_u=(0.0, 0.0, 1.0),
        fov_deg=90.0,
        device=device,
    )
    return SceneBundle(scene, atlas, uniforms)


def city(n_buildings=1650, seed=7, device="cuda") -> SceneBundle:
    """Map-scale stress scene (~17k triangles): a court of box buildings
    under a sunlit sky with scattered emissive panels. Stands in for a
    real Quake map (ad_azad-class triangle counts) in benchmarks."""
    rng = np.random.default_rng(seed)
    textures = [
        _const_tex((255, 255, 255), 1),  # 0 dummy
        _checker_tex((150, 140, 130), (110, 100, 95)),  # 1 ground
        _const_tex((140, 135, 128)),  # 2 walls a
        _const_tex((120, 122, 130)),  # 3 walls b
        _sky_tex(seed=11),  # 4 sky back
        _sky_tex(seed=13),  # 5 sky front
    ]
    b = _SoupBuilder()
    S = 4000.0
    b.quad((0, 0, 0), (S, 0, 0), (0, S, 0), uv_scale=(40, 40), texnum=1)
    # sky box around the city
    Z = 700.0
    SKY = materials.MAT_FLAGS_SKY
    b.quad((0, 0, Z), (0, S, 0), (S, 0, 0), texnum=4, flags=SKY)
    b.quad((S, 0, 0), (0, 0, Z), (0, S, 0), texnum=4, flags=SKY)
    b.quad((0, 0, 0), (0, S, 0), (0, 0, Z), texnum=4, flags=SKY)
    b.quad((0, S, 0), (S, 0, 0), (0, 0, Z), texnum=4, flags=SKY)
    b.quad((0, 0, 0), (0, 0, Z), (S, 0, 0), texnum=4, flags=SKY)
    for i in range(n_buildings):
        x, y = rng.uniform(100, S - 250, 2)
        w, d, h = rng.uniform(40, 150, 3)
        tex = 2 + int(rng.uniform() < 0.5)
        b.quad((x, y, h), (w, 0, 0), (0, d, 0), texnum=tex)
        b.quad((x, y, 0), (0, 0, h), (0, d, 0), texnum=tex)
        b.quad((x + w, y, 0), (0, d, 0), (0, 0, h), texnum=tex)
        b.quad((x, y, 0), (w, 0, 0), (0, 0, h), texnum=tex)
        b.quad((x, y + d, 0), (0, 0, h), (w, 0, 0), texnum=tex)
        if i % 37 == 0:  # scattered emissive panels
            e = rng.uniform(4, 12)
            b.quad(
                (x, y - 0.5, h * 0.4), (w, 0, 0), (0, 0, h * 0.2),
                flags=materials.MAT_FLAGS_SOLID,
                solid_albedo=(0.9, 0.85, 0.7),
                solid_emission=(e, e * 0.9, e * 0.7),
            )
    scene = b.build(device)
    atlas = pack_textures(textures, device=device)
    uniforms = default_uniforms(
        cam_x=(60.0, 60.0, 140.0),
        cam_w=(0.70, 0.70, -0.10),
        cam_u=(0.0, 0.0, 1.0),
        fov_deg=90.0,
        sun_w=(0.4, 0.3, 0.87),
        sun_color=(8.0, 7.5, 6.5),
        sky_classic=(4, 5),
        device=device,
    )
    return SceneBundle(scene, atlas, uniforms)


def furnace(albedo=0.5, emission=1.0, device="cuda") -> SceneBundle:
    """Closed cube, every face uniformly emissive with constant albedo.

    Energy-conservation test scene: with the reference integrator's
    break-on-emission rule every path has exactly one bounce, so pixel
    irradiance must equal emission × ∫ bsdf·cos dω (≈ 1 without albedo)
    — an analytic check on BSDF energy + integrator weighting.
    """
    b = _SoupBuilder()
    S = 256.0
    kw = dict(
        flags=materials.MAT_FLAGS_SOLID,
        solid_albedo=(albedo,) * 3,
        solid_emission=(emission,) * 3,
    )
    b.quad((0, 0, 0), (S, 0, 0), (0, S, 0), **kw)  # floor +z
    b.quad((0, 0, S), (0, S, 0), (S, 0, 0), **kw)  # ceiling -z
    b.quad((S, 0, 0), (0, 0, S), (0, S, 0), **kw)  # far -x
    b.quad((0, 0, 0), (0, S, 0), (0, 0, S), **kw)  # near +x
    b.quad((0, S, 0), (S, 0, 0), (0, 0, S), **kw)  # left -y
    b.quad((0, 0, 0), (0, 0, S), (S, 0, 0), **kw)  # right +y
    scene = b.build(device)
    atlas = pack_textures([_const_tex((255, 255, 255), 1)], device=device)
    uniforms = default_uniforms(
        cam_x=(40.0, 128.0, 128.0), cam_w=(1.0, 0.0, 0.0), fov_deg=90.0, device=device
    )
    return SceneBundle(scene, atlas, uniforms)


SCENES = {
    "box": cornell_box,
    "court": outdoor_court,
    "furnace": furnace,
    "alcove": alcove,
    "city": city,
}


def get_scene(name: str, **kw) -> SceneBundle:
    return SCENES[name](**kw)
