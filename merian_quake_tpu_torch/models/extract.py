"""BSP map → renderable SceneBundle.

Mirrors the reference's static-brush extraction
(quake_node.cpp:847-894 update_static_geo + quake_helpers.cpp:361-469
add_geo_brush): triangle-fan tessellation, texinfo UVs, material flags
from texture names, 'skip' surfaces culled, fullbright texels split
into emission textures, winding fixed against the face plane normal.

Port of merian_quake_tpu/models/extract.py: the same numpy extraction;
the bundle (scene, atlas, uniforms) is placed on ``device``, the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np

from . import materials, palette as pal_mod
from .atlas import pack_textures
from .bsp import BspMap, parse_worldspawn_sun, texture_flags
from .procedural import SceneBundle, _SoupBuilder
from .types import default_uniforms


def scene_from_bsp(
    bsp: BspMap,
    palette: np.ndarray | None = None,
    include_submodels: bool = True,
    device="cuda",
) -> SceneBundle:
    palette = palette if palette is not None else pal_mod.default_palette()

    # --- build texture list: 0 = dummy, then per-miptex albedo (+fb) ---
    textures = [np.full((1, 1, 4), 255, np.uint8)]
    albedo_id: dict[int, int] = {}
    fb_id: dict[int, int] = {}
    sky_ids: list[int] = []
    for ti, tex in enumerate(bsp.textures):
        if tex is None:
            continue
        fence = tex.name.startswith("{")
        rgba = pal_mod.indexed_to_rgba(tex.pixels, palette, fence=fence)
        albedo_id[ti] = len(textures)
        textures.append(rgba)
        if tex.name.lower().startswith("sky"):
            sky_ids.append(albedo_id[ti])
        fb = pal_mod.fullbright_mask(tex.pixels)
        if fb.any() and not tex.name.lower().startswith("sky"):
            em = rgba.copy()
            em[~fb, :3] = 0
            em[..., 3] = 255
            fb_id[ti] = len(textures)
            textures.append(em)

    b = _SoupBuilder()
    models = bsp.models if bsp.models else []
    n_models = len(models) if include_submodels else min(1, len(models))
    face_range = []
    if models:
        for m in models[:n_models]:
            face_range.append(range(m.first_face, m.first_face + m.num_faces))
    else:
        face_range.append(range(len(bsp.faces)))

    for rng in face_range:
        for fi in rng:
            face = bsp.faces[fi]
            ti = face.texinfo
            mip = int(bsp.texinfo_miptex[ti]) if ti < len(bsp.texinfo_miptex) else -1
            tex = bsp.textures[mip] if 0 <= mip < len(bsp.textures) else None
            name = tex.name.lower() if tex else ""
            if name.startswith("skip") or name == "trigger":
                continue  # culled surfaces (quake_helpers 'skip')
            flags = texture_flags(name) if tex else materials.MAT_FLAGS_NONE
            texnum = albedo_id.get(mip, 0)
            fbnum = fb_id.get(mip, 0)

            poly = face.vertices
            if poly.shape[0] < 3:
                continue
            # UVs from texinfo planes over texture size
            s = bsp.texinfo[ti, 0]
            t = bsp.texinfo[ti, 1]
            tw = float(tex.width) if tex else 64.0
            th = float(tex.height) if tex else 64.0
            uv = np.stack(
                [
                    (poly @ s[:3] + s[3]) / tw,
                    (poly @ t[:3] + t[3]) / th,
                ],
                axis=-1,
            )
            # face normal from plane (+side flip)
            pn = bsp.planes[face.plane, :3]
            if face.side:
                pn = -pn
            alpha = 0.999 if name.startswith("{") else -1.0
            # the reference encodes fence alpha via the texture; alpha<0
            # means "use texture" — keep that for fence textures too
            alpha = -1.0
            for k in range(1, poly.shape[0] - 1):
                a, b1, c = poly[0], poly[k], poly[k + 1]
                # our convention: n = cross(v2-v0, v1-v0); match plane normal
                n_tri = np.cross(c - a, b1 - a)
                if np.dot(n_tri, pn) < 0:
                    b1, c = c, b1
                    st = (uv[0], uv[k + 1], uv[k])
                else:
                    st = (uv[0], uv[k], uv[k + 1])
                b.tri(
                    a,
                    b1,
                    c,
                    st=tuple(tuple(x) for x in st),
                    texnum=texnum,
                    fb=fbnum,
                    flags=flags,
                    alpha=alpha,
                )

    scene = b.build(device=device)
    atlas = pack_textures(textures, device=device)
    sun_dir, sun_color = parse_worldspawn_sun(bsp.entities)

    # camera: info_player_start if present
    cam_x = (0.0, 0.0, 64.0)
    cam_w = (1.0, 0.0, 0.0)
    for ent in bsp.entities:
        if ent.get("classname") == "info_player_start":
            try:
                cam_x = tuple(float(v) for v in ent["origin"].split()[:3])
                cam_x = (cam_x[0], cam_x[1], cam_x[2] + 22.0)  # eye height
            except (KeyError, ValueError):
                pass
            yaw = np.deg2rad(float(ent.get("angle", 0.0) or 0.0))
            cam_w = (float(np.cos(yaw)), float(np.sin(yaw)), 0.0)
            break

    sky = (sky_ids[0], sky_ids[0]) if sky_ids else (-1, -1)
    uniforms = default_uniforms(
        cam_x=cam_x,
        cam_w=cam_w,
        cam_u=(0.0, 0.0, 1.0),
        fov_deg=90.0,
        sun_w=tuple(sun_dir.tolist()),
        sun_color=tuple(sun_color.tolist()),
        sky_classic=sky,
        device=device,
    )
    return SceneBundle(scene, atlas, uniforms)
