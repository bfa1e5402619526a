"""Quake BSP29/BSP2 map loader → triangle soup + textures + entities.

Equivalent of the quakespasm model loader + the reference's brush
extraction (quake_helpers.cpp:361-469 add_geo_brush): faces become
triangle fans, UVs come from texinfo planes over texture dimensions,
material flags derive from texture-name conventions ('*lava', '*slime',
'*teleport', '*' water, 'sky', '{' fence/alpha, 'skip' culled), and
fullbright palette indices produce separate emission textures
(texnum_fb). Entities are parsed for worldspawn sun keys
(quake_node.cpp:231-313 style) and submodel placement.

Copy of merian_quake_tpu/models/bsp.py (jax-free numpy).
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

from . import materials, palette as pal_mod

LUMP_ENTITIES = 0
LUMP_PLANES = 1
LUMP_TEXTURES = 2
LUMP_VERTEXES = 3
LUMP_TEXINFO = 6
LUMP_FACES = 7
LUMP_EDGES = 12
LUMP_SURFEDGES = 13
LUMP_MODELS = 14
HEADER_LUMPS = 15


class BspTexture(NamedTuple):
    name: str
    width: int
    height: int
    pixels: np.ndarray  # u8[h, w] indexed (mip 0)


class BspFace(NamedTuple):
    plane: int
    side: int
    vertices: np.ndarray  # f32[k, 3] polygon winding
    texinfo: int


class BspModel(NamedTuple):
    mins: np.ndarray
    maxs: np.ndarray
    first_face: int
    num_faces: int


class BspMap(NamedTuple):
    vertices: np.ndarray
    planes: np.ndarray  # f32[n, 4] normal + dist
    textures: list
    texinfo: np.ndarray  # f32[n, 2, 4] s/t rows
    texinfo_miptex: np.ndarray  # i32[n]
    faces: list
    models: list
    entities: list


def parse_entities(text: str) -> list[dict]:
    """Parse the classic { "key" "value" } entity lump."""
    ents, cur, i = [], None, 0
    n = len(text)
    while i < n:
        c = text[i]
        if c == "{":
            cur = {}
            i += 1
        elif c == "}":
            if cur is not None:
                ents.append(cur)
            cur = None
            i += 1
        elif c == '"' and cur is not None:
            j = text.index('"', i + 1)
            key = text[i + 1 : j]
            k = text.index('"', j + 1)
            m = text.index('"', k + 1)
            cur[key] = text[k + 1 : m]
            i = m + 1
        else:
            i += 1
    return ents


def texture_flags(name: str) -> int:
    """Texture-name → MAT_FLAGS_* (quake_helpers.cpp brush flags)."""
    n = name.lower()
    if n.startswith("sky"):
        return materials.MAT_FLAGS_SKY
    if n.startswith("*"):
        if "lava" in n:
            return materials.MAT_FLAGS_LAVA
        if "slime" in n:
            return materials.MAT_FLAGS_SLIME
        if "tele" in n:
            return materials.MAT_FLAGS_TELE
        return materials.MAT_FLAGS_WATER
    return materials.MAT_FLAGS_NONE


def load_bsp(data: bytes) -> BspMap:
    (version,) = struct.unpack_from("<i", data, 0)
    bsp2 = False
    ofs = 4
    if version == 29:
        pass
    elif data[:4] == b"BSP2":
        bsp2 = True
    else:
        raise ValueError(f"unsupported BSP version {version}")

    lumps = []
    for i in range(HEADER_LUMPS):
        o, l = struct.unpack_from("<ii", data, ofs + i * 8)
        lumps.append((o, l))

    def lump(i):
        o, l = lumps[i]
        return data[o : o + l]

    verts = np.frombuffer(lump(LUMP_VERTEXES), "<f4").reshape(-1, 3).copy()
    planes_raw = np.frombuffer(lump(LUMP_PLANES), "<f4").reshape(-1, 5)
    planes = planes_raw[:, :4].copy()

    # textures (miptex directory)
    tex_lump = lump(LUMP_TEXTURES)
    textures: list[BspTexture | None] = []
    if len(tex_lump) >= 4:
        (num_tex,) = struct.unpack_from("<i", tex_lump, 0)
        offs = struct.unpack_from(f"<{num_tex}i", tex_lump, 4)
        for off in offs:
            if off < 0:
                textures.append(None)
                continue
            name = tex_lump[off : off + 16].split(b"\0", 1)[0].decode("latin-1")
            w, h = struct.unpack_from("<ii", tex_lump, off + 16)
            (mip0,) = struct.unpack_from("<i", tex_lump, off + 24)
            pix = np.frombuffer(
                tex_lump, np.uint8, count=w * h, offset=off + mip0
            ).reshape(h, w).copy()
            textures.append(BspTexture(name, w, h, pix))

    ti_raw = lump(LUMP_TEXINFO)
    n_ti = len(ti_raw) // 40
    texinfo = np.zeros((n_ti, 2, 4), np.float32)
    texinfo_miptex = np.zeros((n_ti,), np.int32)
    for i in range(n_ti):
        vals = struct.unpack_from("<8f2i", ti_raw, i * 40)
        texinfo[i, 0] = vals[0:4]
        texinfo[i, 1] = vals[4:8]
        texinfo_miptex[i] = vals[8]

    if bsp2:
        edges = np.frombuffer(lump(LUMP_EDGES), "<u4").reshape(-1, 2)
    else:
        edges = np.frombuffer(lump(LUMP_EDGES), "<u2").reshape(-1, 2)
    surfedges = np.frombuffer(lump(LUMP_SURFEDGES), "<i4")

    faces_raw = lump(LUMP_FACES)
    faces = []
    if bsp2:
        fsize, ffmt = 28, "<iiihh"  # plane, side, firstedge, numedges(i)...
    else:
        fsize, ffmt = 20, None
    count = len(faces_raw) // fsize
    for i in range(count):
        if bsp2:
            plane, side, first_edge, num_edges, ti = struct.unpack_from(
                "<iiiii", faces_raw, i * 28
            )[:5]
        else:
            plane, side, first_edge, num_edges, ti = struct.unpack_from(
                "<HHiHH", faces_raw, i * 20
            )
        poly = []
        for k in range(num_edges):
            se = surfedges[first_edge + k]
            if se >= 0:
                poly.append(edges[se][0])
            else:
                poly.append(edges[-se][1])
        faces.append(
            BspFace(
                plane=plane,
                side=side,
                vertices=verts[np.asarray(poly, np.int64)],
                texinfo=ti,
            )
        )

    models_raw = lump(LUMP_MODELS)
    models = []
    for i in range(len(models_raw) // 64):
        vals = struct.unpack_from("<9f7i", models_raw, i * 64)
        models.append(
            BspModel(
                mins=np.asarray(vals[0:3], np.float32),
                maxs=np.asarray(vals[3:6], np.float32),
                first_face=vals[14],
                num_faces=vals[15],
            )
        )

    entities = parse_entities(lump(LUMP_ENTITIES).decode("latin-1", "ignore"))
    return BspMap(
        vertices=verts,
        planes=planes,
        textures=textures,
        texinfo=texinfo,
        texinfo_miptex=texinfo_miptex,
        faces=faces,
        models=models,
        entities=entities,
    )


# Per-map worldspawn patches (quake_node.cpp:304-310): some maps carry
# wrong/missing sun keys and the reference hardcodes fixes keyed on a
# distinctive worldspawn property. Data-driven here so more maps can be
# added; each entry: (match key, match value) -> (sun_dir, sun_color).
WORLDSPAWN_SUN_PATCHES = {
    # ad_tears (identified by its skybox prefix)
    ("sky", "stormydays_"): (
        np.asarray([1.0, -1.0, 1.0], np.float32),
        6.0 * np.asarray([1.1, 1.0, 0.9], np.float32),
    ),
}


def _yuv_luminance(rgb) -> float:
    return float(0.299 * rgb[0] + 0.587 * rgb[1] + 0.114 * rgb[2])


def parse_worldspawn_sun(entities: list[dict]):
    """Sun direction/color from worldspawn keys, reproducing the
    reference's conventions (quake_node.cpp:231-313):

    - brightest of sunlight/sunlight2/sunlight3 by luminance, each
      scaled by intensity/4000 with its ``<key>_color`` (white default);
    - sun_mangle read as (yaw, pitch, roll) with yaw flipped 180° and
      fed through Quake's AngleVectors — direction points TOWARD the
      sun (the reference notes the convention "works on ad_azad");
    - per-map patch table (WORLDSPAWN_SUN_PATCHES);
    - hue-preserving clamp to MAX_SUN_COLOR (fp16 overflow guard).

    Leading underscores on keys are stripped by parse_entities lookups
    here (the reference strips them in its parse loop)."""
    ws = entities[0] if entities else {}

    def get(key, default=None):
        return ws.get("_" + key, ws.get(key, default))

    sun_color = np.zeros(3, np.float32)
    for k in ("sunlight", "sunlight2", "sunlight3"):
        v = get(k)
        if v is None:
            continue
        col_s = get(k + "_color")
        if col_s is not None:
            try:
                col = np.asarray(
                    [float(x) for x in col_s.split()[:3]], np.float32
                )
            except ValueError:
                col = np.ones(3, np.float32)
        else:
            col = np.ones(3, np.float32)
        try:
            intensity = float(int(float(v)))
        except ValueError:
            intensity = 0.0
        col = col * (intensity / 4000.0)
        if _yuv_luminance(col) > _yuv_luminance(sun_color):
            sun_color = col

    mangle = get("sun_mangle")
    if mangle is not None:
        try:
            a0, a1, _ = (float(x) for x in mangle.split()[:3])
        except ValueError:
            a0, a1 = 0.0, 0.0
        # reference order: first number → yaw, second → pitch, with the
        # yaw flipped by 180° before AngleVectors (forward.z = -sin p)
        yaw_r = np.deg2rad(a0 - 180.0)
        pitch_r = np.deg2rad(a1)
        d = np.asarray(
            [
                np.cos(pitch_r) * np.cos(yaw_r),
                np.cos(pitch_r) * np.sin(yaw_r),
                -np.sin(pitch_r),
            ],
            np.float32,
        )
    else:
        d = np.ones(3, np.float32)

    for (mk, mv), (pd, pc) in WORLDSPAWN_SUN_PATCHES.items():
        if get(mk) == mv:
            d, sun_color = pd.copy(), pc.copy()

    mx = float(sun_color.max())
    if mx > materials.MAX_SUN_COLOR:
        sun_color = sun_color / mx * materials.MAX_SUN_COLOR
    return d / max(np.linalg.norm(d), 1e-12), sun_color


class BspCollision(NamedTuple):
    """Flat collision tables for the game host (game/host.py
    ``QuakeHost.load_world``): the world + submodel hulls.

    Hull 0 is synthesized from the render nodes/leafs (Mod_MakeHull0
    semantics: node children become clipnode children, leaves collapse
    to their contents); hulls 1-2 come straight from the clipnodes
    lump, offset past the hull-0 block so one table serves all hulls.
    """

    planes: np.ndarray  # f32[NP, 4]
    clipnodes: np.ndarray  # i32[NC, 3] planenum, child0, child1
    headnodes: np.ndarray  # i32[NM, 3]
    bounds: np.ndarray  # f32[NM, 6]


LUMP_NODES = 5
LUMP_CLIPNODES = 9
LUMP_LEAFS = 10


def load_collision(data: bytes) -> BspCollision:
    (version,) = struct.unpack_from("<i", data, 0)
    bsp2 = data[:4] == b"BSP2"
    if not bsp2 and version != 29:
        raise ValueError(f"unsupported BSP version {version}")

    lumps = []
    for i in range(HEADER_LUMPS):
        o, l = struct.unpack_from("<ii", data, 4 + i * 8)
        lumps.append((o, l))

    def lump(i):
        o, l = lumps[i]
        return data[o : o + l]

    planes = (
        np.frombuffer(lump(LUMP_PLANES), "<f4").reshape(-1, 5)[:, :4].copy()
    )

    # render nodes → hull-0 clipnodes
    raw = lump(LUMP_NODES)
    if bsp2:
        # BSP2 dnode: i32 planenum, i32 children[2], f32 mins/maxs[3],
        # u32 firstface/numfaces = 44 bytes
        stride, cfmt = 44, "<iii"
    else:
        # BSP29 dnode: i32 planenum, i16 children[2], i16 bounds[6],
        # u16 firstface/numfaces = 24 bytes
        stride, cfmt = 24, "<ihh"
    n_nodes = len(raw) // stride
    node_plane = np.empty((n_nodes,), np.int64)
    node_child = np.empty((n_nodes, 2), np.int64)
    for i in range(n_nodes):
        pn, c0, c1 = struct.unpack_from(cfmt, raw, i * stride)
        node_plane[i] = pn
        node_child[i] = (c0, c1)

    # leaf contents (for hull-0 leaf collapse)
    raw = lump(LUMP_LEAFS)
    if bsp2:
        # i32 contents, i32 visofs, f32 bounds[6], u32 first/num, u8[4]
        lstride = 44
    else:
        # i32 contents, i32 visofs, i16 bounds[6], u16 first/num, u8[4]
        lstride = 28
    n_leafs = len(raw) // lstride
    leaf_contents = np.array(
        [struct.unpack_from("<i", raw, i * lstride)[0] for i in range(n_leafs)],
        np.int64,
    )

    hull0 = np.empty((n_nodes, 3), np.int64)
    for i in range(n_nodes):
        hull0[i, 0] = node_plane[i]
        for k in range(2):
            c = node_child[i, k]
            # node children: >= 0 node index, < 0 → leaf -(c+1)
            hull0[i, 1 + k] = c if c >= 0 else leaf_contents[-1 - c]

    # clipnodes lump (hulls 1-2), children offset past the hull-0 block
    raw = lump(LUMP_CLIPNODES)
    if bsp2:
        cstride, ccfmt = 12, "<iii"
    else:
        cstride, ccfmt = 8, "<ihh"
    n_clip = len(raw) // cstride
    clip = np.empty((n_clip, 3), np.int64)
    for i in range(n_clip):
        pn, c0, c1 = struct.unpack_from(ccfmt, raw, i * cstride)
        clip[i] = (
            pn,
            c0 + n_nodes if c0 >= 0 else c0,
            c1 + n_nodes if c1 >= 0 else c1,
        )
    clipnodes = np.concatenate([hull0, clip]).astype(np.int32)

    # models: headnode[0] = render node (hull0 index unchanged),
    # headnode[1..2] = clipnode indices (offset)
    raw = lump(LUMP_MODELS)
    n_models = len(raw) // 64
    headnodes = np.zeros((n_models, 3), np.int32)
    bounds = np.zeros((n_models, 6), np.float32)
    for i in range(n_models):
        vals = struct.unpack_from("<9f7i", raw, i * 64)
        bounds[i, 0:3] = vals[0:3]
        bounds[i, 3:6] = vals[3:6]
        h0, h1, h2 = vals[9], vals[10], vals[11]
        headnodes[i] = (
            h0,
            h1 + n_nodes if h1 >= 0 else h1,
            h2 + n_nodes if h2 >= 0 else h2,
        )
    return BspCollision(
        planes=planes, clipnodes=clipnodes, headnodes=headnodes,
        bounds=bounds,
    )
