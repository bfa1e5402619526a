"""Quake alias model (.mdl, IDPO v6) loader.

Source of the reference's alias geometry path
(quake_helpers.cpp:218-359 add_geo_alias): keyframe poses in packed
trivertx form, per-vertex seam-corrected UVs, indexed skins. The loader
returns pose vertex arrays decoded to model space; pose pair
interpolation (R_SetupAliasFrame lerp) happens in the game layer.

Copy of merian_quake_tpu/models/mdl.py (jax-free numpy).
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from . import palette as pal_mod


class AliasModel(NamedTuple):
    name: str
    scale: np.ndarray  # f32[3]
    translate: np.ndarray  # f32[3]
    skins: list  # list of u8[h, w] indexed skins
    skin_width: int
    skin_height: int
    uv: np.ndarray  # f32[t, 3, 2] per-corner, seam-corrected
    tris: np.ndarray  # i32[t, 3]
    frames: np.ndarray  # f32[f, v, 3] decoded model-space positions
    frame_names: list


def load_mdl(data: bytes, name: str = "") -> AliasModel:
    magic, version = struct.unpack_from("<4si", data, 0)
    if magic != b"IDPO" or version != 6:
        raise ValueError(f"not an IDPO v6 mdl (magic={magic!r} v={version})")
    scale = np.frombuffer(data, "<f4", 3, 8).copy()
    translate = np.frombuffer(data, "<f4", 3, 20).copy()
    (numskins,) = struct.unpack_from("<i", data, 48)
    skinw, skinh = struct.unpack_from("<ii", data, 52)
    numverts, numtris, numframes = struct.unpack_from("<iii", data, 60)
    ofs = 84

    skins = []
    for _ in range(numskins):
        (group,) = struct.unpack_from("<i", data, ofs)
        ofs += 4
        if group == 0:
            pix = np.frombuffer(data, np.uint8, skinw * skinh, ofs).reshape(
                skinh, skinw
            )
            skins.append(pix.copy())
            ofs += skinw * skinh
        else:
            (cnt,) = struct.unpack_from("<i", data, ofs)
            ofs += 4 + 4 * cnt  # count + times
            for _ in range(cnt):
                pix = np.frombuffer(data, np.uint8, skinw * skinh, ofs).reshape(
                    skinh, skinw
                )
                skins.append(pix.copy())
                ofs += skinw * skinh

    st_raw = np.frombuffer(data, "<i4", numverts * 3, ofs).reshape(numverts, 3)
    onseam = st_raw[:, 0] != 0
    s = st_raw[:, 1].astype(np.float32)
    t = st_raw[:, 2].astype(np.float32)
    ofs += numverts * 12

    tri_raw = np.frombuffer(data, "<i4", numtris * 4, ofs).reshape(numtris, 4)
    faces_front = tri_raw[:, 0] != 0
    tris = tri_raw[:, 1:4].astype(np.int32).copy()
    ofs += numtris * 16

    # seam correction: back-facing triangles shift seam verts by w/2
    uv = np.zeros((numtris, 3, 2), np.float32)
    for c in range(3):
        vi = tris[:, c]
        ss = s[vi].copy()
        shift = (~faces_front) & onseam[vi]
        ss[shift] += skinw * 0.5
        uv[:, c, 0] = (ss + 0.5) / skinw
        uv[:, c, 1] = (t[vi] + 0.5) / skinh

    frames = np.zeros((numframes, numverts, 3), np.float32)
    frame_names = []
    fi = 0
    for _ in range(numframes):
        (ftype,) = struct.unpack_from("<i", data, ofs)
        ofs += 4
        if ftype != 0:
            (cnt,) = struct.unpack_from("<i", data, ofs)
            ofs += 4 + 8 + 4 * cnt  # count + group bbox triverts + times
            sub = cnt
        else:
            sub = 1
        for _ in range(sub):
            ofs += 8  # bboxmin/bboxmax triverts
            fname = data[ofs : ofs + 16].split(b"\0", 1)[0].decode("latin-1")
            ofs += 16
            tv = np.frombuffer(data, np.uint8, numverts * 4, ofs).reshape(
                numverts, 4
            )
            if fi < numframes:
                frames[fi] = tv[:, :3].astype(np.float32) * scale + translate
                frame_names.append(fname)
                fi += 1
            ofs += numverts * 4
    frames = frames[:fi]

    return AliasModel(
        name=name,
        scale=scale,
        translate=translate,
        skins=skins,
        skin_width=skinw,
        skin_height=skinh,
        uv=uv,
        tris=tris,
        frames=frames,
        frame_names=frame_names,
    )


def write_mdl(
    skins: list[np.ndarray],
    uv_s: np.ndarray,
    uv_t: np.ndarray,
    onseam: np.ndarray,
    tris: np.ndarray,
    faces_front: np.ndarray,
    frames_xyz: np.ndarray,
    scale: np.ndarray,
    translate: np.ndarray,
) -> bytes:
    """Serialize an IDPO v6 mdl (tests/tooling)."""
    skinh, skinw = skins[0].shape
    numverts = len(uv_s)
    numtris = len(tris)
    numframes = frames_xyz.shape[0]
    out = bytearray()
    out += struct.pack("<4si", b"IDPO", 6)
    out += np.asarray(scale, "<f4").tobytes()
    out += np.asarray(translate, "<f4").tobytes()
    out += struct.pack("<f", 64.0)  # boundingradius
    out += struct.pack("<3f", 0, 0, 0)  # eyeposition
    out += struct.pack("<i", len(skins))
    out += struct.pack("<ii", skinw, skinh)
    out += struct.pack("<iii", numverts, numtris, numframes)
    out += struct.pack("<iii", 0, 0, 0)  # synctype, flags, size
    assert len(out) == 84
    for sk in skins:
        out += struct.pack("<i", 0) + sk.astype(np.uint8).tobytes()
    for i in range(numverts):
        out += struct.pack("<iii", int(onseam[i]), int(uv_s[i]), int(uv_t[i]))
    for i in range(numtris):
        out += struct.pack(
            "<iiii", int(faces_front[i]), *(int(v) for v in tris[i])
        )
    for f in range(numframes):
        out += struct.pack("<i", 0)
        q = np.clip(
            (frames_xyz[f] - translate) / np.maximum(scale, 1e-9), 0, 255
        ).astype(np.uint8)
        out += bytes([0, 0, 0, 0, 255, 255, 255, 0])  # bbox triverts
        out += b"frame".ljust(16, b"\0")
        tv = np.zeros((numverts, 4), np.uint8)
        tv[:, :3] = q
        out += tv.tobytes()
    return bytes(out)
