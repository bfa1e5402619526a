"""Quake sprite (.spr, IDSP v1) loader.

Source format for the reference's sprite geometry path
(quake_helpers.cpp:471-626 add_geo_sprite): orientation type, per-frame
origin offsets and 8-bit indexed images. Sprites are always emissive
(MAT_FLAGS_SPRITE) and double-sided.

Copy of merian_quake_tpu/models/spr.py (jax-free numpy).
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

SPR_VP_PARALLEL_UPRIGHT = 0
SPR_FACING_UPRIGHT = 1
SPR_VP_PARALLEL = 2
SPR_ORIENTED = 3
SPR_VP_PARALLEL_ORIENTED = 4


class SpriteFrame(NamedTuple):
    origin: tuple  # (x, y) offset of the upper-left corner
    width: int
    height: int
    pixels: np.ndarray  # u8[h, w] indexed


class SpriteModel(NamedTuple):
    name: str
    orientation: int
    radius: float
    frames: list


def load_spr(data: bytes, name: str = "") -> SpriteModel:
    magic, version = struct.unpack_from("<4si", data, 0)
    if magic != b"IDSP" or version != 1:
        raise ValueError(f"not an IDSP v1 sprite ({magic!r} v{version})")
    stype, radius, maxw, maxh, nframes, beam, sync = struct.unpack_from(
        "<ifiiifi", data, 8
    )
    ofs = 36
    frames = []
    for _ in range(nframes):
        (group,) = struct.unpack_from("<i", data, ofs)
        ofs += 4
        count = 1
        if group != 0:
            (count,) = struct.unpack_from("<i", data, ofs)
            ofs += 4 + 4 * count  # count + intervals
        for _ in range(count):
            ox, oy, w, h = struct.unpack_from("<iiii", data, ofs)
            ofs += 16
            pix = np.frombuffer(data, np.uint8, w * h, ofs).reshape(h, w).copy()
            ofs += w * h
            frames.append(SpriteFrame(origin=(ox, oy), width=w, height=h, pixels=pix))
    return SpriteModel(name=name, orientation=stype, radius=radius, frames=frames)


def write_spr(frames: list[np.ndarray], orientation: int = SPR_VP_PARALLEL) -> bytes:
    """Serialize an IDSP v1 sprite (tests/tooling)."""
    maxw = max(f.shape[1] for f in frames)
    maxh = max(f.shape[0] for f in frames)
    out = bytearray()
    out += struct.pack("<4si", b"IDSP", 1)
    out += struct.pack(
        "<ifiiifi", orientation, float(max(maxw, maxh)), maxw, maxh,
        len(frames), 0.0, 0,
    )
    for f in frames:
        h, w = f.shape
        out += struct.pack("<i", 0)  # single frame
        out += struct.pack("<iiii", -(w // 2), h // 2, w, h)
        out += f.astype(np.uint8).tobytes()
    return bytes(out)
