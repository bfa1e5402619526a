"""Particle and sprite geometry extraction.

Port of quake_helpers.cpp:
- add_particles (:50-216): each particle becomes a small tetrahedron
  with randomized rotation/offset (XorShift-seeded, derandomized in
  reproducible mode); bright palette colors are emissive; color
  heuristics classify blood/explosion-style particles.
- add_geo_sprite (:471-626): double-sided camera-facing quads per the
  sprite's orientation mode, always emissive (MAT_FLAGS_SPRITE).

Copy of merian_quake_tpu/game/particles.py (jax-free numpy).
"""
from __future__ import annotations

import numpy as np

from ..models import materials, palette as pal_mod
from ..models.spr import (
    SPR_FACING_UPRIGHT,
    SPR_ORIENTED,
    SPR_VP_PARALLEL,
    SPR_VP_PARALLEL_UPRIGHT,
    SpriteModel,
)

# unit tetrahedron (4 faces), centered-ish at origin
_TET = np.asarray(
    [
        [1, 1, 1],
        [1, -1, -1],
        [-1, 1, -1],
        [-1, -1, 1],
    ],
    np.float32,
) / np.sqrt(3.0)
_TET_FACES = np.asarray(
    [[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]], np.int32
)


def _xorshift(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x << np.uint32(13)
    x ^= x >> np.uint32(17)
    x ^= x << np.uint32(5)
    return x


def particles_to_soup(
    origins: np.ndarray,  # f32[P, 3]
    color_indices: np.ndarray,  # u8[P] palette indices
    palette: np.ndarray | None = None,
    size: float = 1.0,
    seed: int = 1337,
    reproducible: bool = True,
):
    """Particles → (v0, v1, v2, albedo, emission) triangle arrays.

    Randomized per-particle rotation (reproducible: keyed on the
    particle index; otherwise on index+seed — quake_helpers.cpp:82-83).
    Bright/fullbright palette colors emit (explosions, teleporter
    sparks); dark colors (blood, smoke) are diffuse only.
    """
    palette = palette if palette is not None else pal_mod.default_palette()
    p = origins.shape[0]
    if p == 0:
        z = np.zeros((0, 3), np.float32)
        return z, z, z, z, z
    keys = np.arange(1, p + 1, dtype=np.uint32)
    if not reproducible:
        keys = keys * np.uint32(2654435761) + np.uint32(seed)
    r1 = _xorshift(keys)
    r2 = _xorshift(r1)
    r3 = _xorshift(r2)
    to_f = lambda r: r.astype(np.float64) / 4294967296.0
    yaw = to_f(r1) * 2 * np.pi
    pitch = to_f(r2) * np.pi
    jitter = (to_f(r3)[:, None] - 0.5) * 0.3 * size

    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    rot = np.zeros((p, 3, 3), np.float32)
    rot[:, 0] = np.stack([cy * cp, -sy, cy * sp], -1)
    rot[:, 1] = np.stack([sy * cp, cy, sy * sp], -1)
    rot[:, 2] = np.stack([-sp, np.zeros_like(sp), cp], -1)

    verts = (_TET[None] * size) @ np.swapaxes(rot, 1, 2) + (
        origins + jitter
    )[:, None, :]
    tris = verts[:, _TET_FACES]  # (P, 4, 3 corners, 3)
    v0 = tris[:, :, 0].reshape(-1, 3).astype(np.float32)
    v1 = tris[:, :, 1].reshape(-1, 3).astype(np.float32)
    v2 = tris[:, :, 2].reshape(-1, 3).astype(np.float32)

    rgb = palette[color_indices].astype(np.float32) / 255.0
    bright = pal_mod.fullbright_mask(color_indices) | (rgb.max(-1) > 0.8)
    albedo = np.repeat(rgb, 4, axis=0)
    emission = np.repeat(
        np.where(bright[:, None], rgb * 4.0, 0.0), 4, axis=0
    ).astype(np.float32)
    return v0, v1, v2, albedo, emission


def sprite_quad(
    sprite: SpriteModel,
    frame_idx: int,
    origin: np.ndarray,
    cam_pos: np.ndarray,
    cam_up=(0.0, 0.0, 1.0),
    angles_yaw: float = 0.0,
    scale: float = 1.0,
):
    """One double-sided quad for a sprite frame (orientation modes of
    add_geo_sprite). Returns (v0, v1, v2) arrays of 4 triangles + uv."""
    fr = sprite.frames[frame_idx % len(sprite.frames)]
    fwd = np.asarray(origin, np.float32) - np.asarray(cam_pos, np.float32)
    dist = np.linalg.norm(fwd)
    fwd = fwd / max(dist, 1e-6)
    world_up = np.asarray(cam_up, np.float32)

    if sprite.orientation in (SPR_VP_PARALLEL_UPRIGHT, SPR_FACING_UPRIGHT):
        up = world_up
        right = np.cross(fwd, up)
        right /= max(np.linalg.norm(right), 1e-6)
    elif sprite.orientation == SPR_ORIENTED:
        c, s = np.cos(np.radians(angles_yaw)), np.sin(np.radians(angles_yaw))
        right = np.asarray([c, s, 0.0], np.float32)
        up = world_up
    else:  # VP_PARALLEL / VP_PARALLEL_ORIENTED
        right = np.cross(fwd, world_up)
        right /= max(np.linalg.norm(right), 1e-6)
        up = np.cross(right, fwd)

    ox, oy = fr.origin
    w, h = fr.width * scale, fr.height * scale
    o = np.asarray(origin, np.float32)
    ul = o + right * ox * scale + up * oy * scale
    corners = [ul, ul + right * w, ul + right * w - up * h, ul - up * h]
    a, b, c, d = corners
    # double-sided: two windings of the same quad
    v0 = np.asarray([a, a, a, a], np.float32)
    v1 = np.asarray([d, b, b, d], np.float32)
    v2 = np.asarray([b, d, d, b], np.float32)
    v1[2:], v2[2:] = v2[2:].copy(), v1[2:].copy()
    uv = np.asarray(
        [
            [(0, 0), (0, 1), (1, 0)],
            [(0, 0), (1, 0), (0, 1)],
            [(0, 0), (1, 0), (0, 1)],
            [(0, 0), (0, 1), (1, 0)],
        ],
        np.float32,
    )
    return v0, v1, v2, uv
