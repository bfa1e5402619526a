"""What the phases read: the scenes, the ray populations, the hand-laid
inputs, and what one phase makes for later ones.

A fixture is a function marked with :func:`fixture`; its parameters name
the fixtures it reads, as a phase's parameters do. :func:`get` builds one
on first use and keeps it until the run releases it (:func:`release`),
once no phase still to run reads it. The fixtures of ``MADE_BY`` are made
by a phase as it runs, which hands them on with :func:`keep`; reading one
runs that phase first where it has not run. The builders here that are no
fixture (``tie_table``, ``edge_boxes``, ``room_bsp`` ...) take their
arguments; the tests on the CPU use them too.
"""
from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from .common import H, MPL, SPP, W, log

# city with 1,600 buildings: 16,128 triangles in 252 clusters, so the
# target key (at most 256 clusters) applies; default city() has 260
CITY1600 = {"n_buildings": 1600, "seed": 7}
MAP = {"n_buildings": 28000, "seed": 11}  # bench.py's map row: 281,536 triangles

FIXTURES: dict = {}
# fixtures a phase makes as it runs and keeps: name -> that phase
MADE_BY = {
    "dev": 1,  # the card, torch.device("cuda", 0)
    "smi": 1,  # nvidia-smi's line of its name and power limit
    "native_build_s": 1,  # seconds g++ took to build the native accel builder
    "restir_city": 6,  # (config, state, out) of city's 6th ReSTIR frame
    "mcpg_city_frames": 16,  # {"ms": frames 12-15, "cold": frame 0} of city MCPG
    "mcpg_city_pops": 16,  # the guided ray populations of city MCPG's frame 17
    "mcpg_city_last": 16,  # (config, mcfg, uniforms, state, out) after the sort A/B
    "mcpg_map_pops": 17,  # the guided ray populations of map MCPG's frame 9
    "dungeon": 30,  # the live dungeon, a live.LiveRun, after its moving frames
}
_built: dict = {}


def fixture(fn):
    FIXTURES[fn.__name__] = fn
    return fn


def reads(fn) -> tuple:
    """The fixtures phase or fixture ``fn`` reads: its parameters without
    a default."""
    return tuple(name for name, p in inspect.signature(fn).parameters.items()
                 if p.default is inspect.Parameter.empty)


def needs(names) -> set:
    """``names`` and every fixture they read, and those read, on down."""
    out, todo = set(), list(names)
    while todo:
        name = todo.pop()
        if name not in out:
            out.add(name)
            if name in FIXTURES:
                todo.extend(reads(FIXTURES[name]))
    return out


def get(name):
    """Fixture ``name``: built, or its phase run, where it is not kept."""
    if name not in _built:
        if name in MADE_BY:
            from .registry import run_phase

            run_phase(MADE_BY[name])
            if name not in _built:
                raise AssertionError(f"phase {MADE_BY[name]} kept no {name}")
        else:
            fn = FIXTURES[name]
            _built[name] = fn(*[get(p) for p in reads(fn)])
    return _built[name]


def keep(**values) -> None:
    """Hand what a phase made on to later phases (``MADE_BY``)."""
    _built.update(values)


def release(wanted) -> None:
    """Drop every kept fixture that is not in ``wanted``."""
    for name in set(_built) - set(wanted):
        del _built[name]


@fixture
def soup_draws(dev):
    """``np.random.default_rng(1337)`` and the random soup drawn from it:
    (rng, (accel, origins, directions)) of 256 triangles and 512 rays, the
    first half from far outside, pointing away. Phase 5 draws on from the
    generator."""
    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.models.types import build_scene_from_soup

    rng = np.random.default_rng(1337)
    n_tri = 256
    c = rng.uniform(-40, 40, (n_tri, 1, 3))
    tri = c + rng.uniform(-8, 8, (n_tri, 3, 3))
    acc_soup = build_accel(build_scene_from_soup(
        tri[:, 0].astype(np.float32), tri[:, 1].astype(np.float32),
        tri[:, 2].astype(np.float32), device=dev,
    ))
    n = 512
    o = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[: n // 2] = 500.0
    d[: n // 2] = np.abs(d[: n // 2])
    return rng, (acc_soup, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))


@fixture
def soup(soup_draws):
    """The random soup: (accel, origins, directions)."""
    return soup_draws[1]


@fixture
def city_scene(dev):
    """The procedural city on the card (16,640 triangles): (bundle,
    accel, config at 1080p, SPP and MPL, with the scene's features)."""
    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig

    bundle = city(device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    return bundle, accel, RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL,
                                       features=feats)


def sparse_warps(t_max):
    """``t_max`` with all but one or two rays of each warp of 32 dead
    (t_max = -1): lane 5 stays, and lane 20 in every other warp. A tile
    visit then has 1-2 reaching lanes, so K1's and K3's compacted visit
    (triangle per lane) tests every tile."""
    lane = torch.arange(t_max.shape[0], device=t_max.device)
    keep = (lane % 32 == 5) | ((lane % 64) == 32 + 20)
    return torch.where(keep, t_max, torch.full_like(t_max, -1.0))


def tie_table(dev, seed=7, n_rays=2048):
    """A hand-laid Woop table (no median split, so the layout is as
    written) of 4 clusters with exact ties, and sparse rays aimed at it:
    (rays, w, lo, hi) as ``woop.k1_inputs`` gives them. Cluster 0 holds 32
    triangles twice (triangle l + 32 is triangle l: the two a lane tests in
    a compacted visit), cluster 1 each triangle twice in a row (2j + 1 is
    2j: ties across lanes), clusters 2-3 are plain. The rays go from
    random origins to the triangles' centroids, one or two live a warp
    (:func:`sparse_warps`). The lowest index must win every tie."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.accel.build import cluster_aabbs

    rng = np.random.default_rng(seed)
    c = rng.uniform(-30, 30, (256, 1, 3))
    tri = (c + rng.uniform(-12, 12, (256, 3, 3))).astype(np.float32)
    tri[32:64] = tri[0:32]
    tri[65:128:2] = tri[64:128:2]
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    w, cand = woop.build_woop(v0, v1, v2, np.ones(256, bool))
    lo, hi = cluster_aabbs(v0, v1, v2, cand)
    to = tri.mean(1)[rng.integers(0, 128, n_rays)]
    o = rng.uniform(-80, 80, (n_rays, 3)).astype(np.float32)
    d = to - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    t_max = sparse_warps(torch.full((n_rays,), 1e4, device=dev))
    rays = woop._pack_rays(t(o), t(d), torch.zeros(n_rays, device=dev), t_max, woop.RAY_BLOCK)
    return rays, woop.pack_table(t(w)), *woop.padded_bounds(t(lo), t(hi))


def primary_rays(bundle, accel, dev):
    from merian_quake_tpu_torch.ops import camera
    from merian_quake_tpu_torch.render import layout

    u = bundle.uniforms
    px, py = layout.gen_pixels(W, H, device=dev)
    d = camera.ray_dir(px.float(), py.float(), W, H, u.cam_u, u.cam_w, u.fov_tan_half)
    return u.cam_x.expand_as(d).contiguous(), d


def bounce_rays(bundle, accel, config, dev):
    """First bounce of the path tracer at frame 0 (render/pt.py)."""
    from merian_quake_tpu_torch.ops import bsdf, linalg, rng
    from merian_quake_tpu_torch.render import layout
    from merian_quake_tpu_torch.render.gbuffer import render_gbuffer
    from merian_quake_tpu_torch.render.hit import decompress_hit

    gbuf = render_gbuffer(accel, bundle.atlas, bundle.uniforms, config)
    cur = decompress_hit(gbuf.hits)
    px, py = layout.gen_pixels(W, H, device=dev)
    state = rng.seed_pixel(px, py, 0, config.seed)
    _, u3 = rng.uniform3(state)
    alpha = bsdf.roughness_to_alpha(cur.roughness)
    wo = bsdf.sample(cur.wi, cur.normal, alpha, u3)
    below = (linalg.dot(wo, cur.normal) <= 1e-3) | (linalg.dot(wo, cur.geo_normal) <= 1e-3)
    live = (cur.albedo >= 1e-7).any(-1) & ~below
    t_max = torch.where(live, 1e4, -1.0)
    return (cur.pos - cur.wi * 1e-3).contiguous(), wo.contiguous(), t_max


def shade_rays(bundle, accel, config, dev):
    """The 1080p shade pass's shadow rays at frame 0: gbuffer points to
    the reservoir samples after spatial reuse (render/restir/restir.py;
    the shade pass discards, it never moves, y_pos), packed as
    ``trace_visibility`` packs them."""
    from merian_quake_tpu_torch.render.gbuffer import render_gbuffer
    from merian_quake_tpu_torch.render.hit import decompress_hit
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig, init_restir_state, render_restir

    rconfig = config._replace(integrator="restir")
    gbuf = render_gbuffer(accel, bundle.atlas, bundle.uniforms, rconfig)
    _, rstate = render_restir(accel, bundle.atlas, bundle.uniforms, rconfig, ReSTIRConfig(),
                              init_restir_state(W, H, device=dev), gbuf)
    frm = decompress_hit(gbuf.hits).pos
    wo = rstate.reservoirs.y_pos - frm
    dist = torch.linalg.vector_norm(wo, dim=-1)
    d = wo / torch.clamp_min(dist, 1e-20)[:, None]
    return frm.contiguous(), d.contiguous(), torch.clamp_min(dist - 2e-3, 1e-3).contiguous()


def grate_soup(dev):
    """A box room with two alpha-tested grates (texture alpha in stripes)
    across it and one opaque pillar: the scene has an alpha-only table."""
    from merian_quake_tpu_torch.models.atlas import pack_textures
    from merian_quake_tpu_torch.models.procedural import _const_tex, _SoupBuilder

    grate = _const_tex((120, 120, 120), size=16, alpha=0)
    grate[:, ::4, 3] = 255  # opaque bars every 4th texel column
    grate[::4, :, 3] = 255
    b = _SoupBuilder()
    X, Y, Z = 200.0, 100.0, 100.0
    for p, du, dv in (((0, 0, 0), (X, 0, 0), (0, Y, 0)), ((0, 0, Z), (0, Y, 0), (X, 0, 0)),
                      ((0, 0, 0), (0, Y, 0), (0, 0, Z)), ((X, 0, 0), (0, 0, Z), (0, Y, 0)),
                      ((0, 0, 0), (0, 0, Z), (X, 0, 0)), ((0, Y, 0), (X, 0, 0), (0, 0, Z))):
        b.quad(p, du, dv, texnum=1)
    for x in (60.0, 130.0):  # two-sided grates across the room
        b.quad((x, 0, 0), (0, Y, 0), (0, 0, Z), uv_scale=(6, 6), texnum=2)
        b.quad((x, 0, 0), (0, 0, Z), (0, Y, 0), uv_scale=(6, 6), texnum=2)
    b.quad((95, 40, 0), (0, 0, Z), (0, 20, 0), texnum=1)  # a pillar wall
    b.quad((95, 40, 0), (0, 20, 0), (0, 0, Z), texnum=1)
    atlas = pack_textures([_const_tex((255, 255, 255), 1), _const_tex((200, 200, 200)), grate],
                          device=dev)
    return b.build(dev), atlas


@fixture
def map_scene(dev):
    """The map scene on the card: (bundle, accel, config at 1080p)."""
    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig

    t0 = time.perf_counter()
    bundle = city(**MAP, device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    log(f"phase 8 map city({MAP['n_buildings']}, {MAP['seed']}): {bundle.scene.num_tris} "
        f"triangles, {accel.cluster_lo.shape[0]} clusters, scene + accel build "
        f"{time.perf_counter() - t0:.2f} s")
    return bundle, accel, RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL,
                                       features=feats)


@fixture
def map_primary(dev, map_scene):
    """The map's 1080p primary rays: (origins, directions)."""
    bundle, accel, _ = map_scene
    return primary_rays(bundle, accel, dev)


@fixture
def city1600(dev):
    """city(1600, 7) on the card: (bundle, accel, 1080p config) and its
    1080p ray populations: primary (pixel order), the first PT bounce in
    pixel order and sorted by the target key, and the shade-pass shadow
    rays."""
    from merian_quake_tpu_torch.accel import build_accel, woop
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig

    bundle = city(**CITY1600, device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    config = RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL,
                          features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas))
    po, pd = primary_rays(bundle, accel, dev)
    bo, bd, bt = bounce_rays(bundle, accel, config, dev)
    perm = torch.sort(woop.target_sort_key(accel, bo, bd, bt), stable=True).indices
    pops = {"primary": (po, pd, torch.zeros_like(bt), torch.full_like(bt, 1e4)),
            "bounce": (bo, bd, torch.zeros_like(bt), bt),
            "bounce_target": (bo[perm].contiguous(), bd[perm].contiguous(),
                              torch.zeros_like(bt), bt[perm].contiguous()),
            "shade": shade_rays(bundle, accel, config, dev)}
    log(f"phase 12 city({CITY1600['n_buildings']}, {CITY1600['seed']}): {bundle.scene.num_tris} "
        f"triangles, {accel.cluster_lo.shape[0]} clusters; bounce rays live "
        f"{float((bt > 0).float().mean()):.4f}")
    return bundle, accel, config, pops


def edge_boxes(rng, m, few_empty=False, device="cpu"):
    """m boxes in [-50, 50]^3 with the cases K4 and K5 must keep exact
    (lo/hi f32[m, 3]): every 5th empty as the padding fills it (3e37 >
    -3e37), every 7th empty as the build fills it (1e30 > -1e30), every 3rd
    inverted on one axis, one with a NaN plane, one flat (lo = hi on an
    axis). The JAX slab enters an empty box at 0 from any finite origin,
    so K4's keys take the first three empty ids: ``few_empty`` leaves only
    two (at 30% and 60% of the ids), so that the third is a real box's."""
    lo = rng.uniform(-50, 45, (m, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.5, 15, (m, 3))).astype(np.float32)
    for c in range(0, m, 3):
        k = c % 3
        lo[c, k], hi[c, k] = hi[c, k], lo[c, k]
    if few_empty:
        lo[3 * m // 10], hi[3 * m // 10] = 1e30, -1e30
        lo[6 * m // 10], hi[6 * m // 10] = 3e37, -3e37
    else:
        lo[4::5], hi[4::5] = 3e37, -3e37
        lo[6::7], hi[6::7] = 1e30, -1e30
    if m > 10:
        lo[10, 1] = np.nan
        hi[8, 2] = lo[8, 2]
    return torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device)


def edge_rays(rng, n=640, device="cpu"):
    """Packed rays f32[8, n] for K4 and K5 around :func:`edge_boxes`:
    origins in and around the boxes, directions with +0, -0 and
    sub-1e-20 components, NaN origins and a NaN direction, limits 1e4,
    +inf, 0, -0, negative, NaN; a warp whose limits are all negative and a
    128-ray block whose limits are all dead."""
    from merian_quake_tpu_torch.accel import woop

    o = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[::9] = rng.uniform(-50, 50, (len(o[::9]), 3))
    d[1::6, 0] = 0.0
    d[2::6, 1] = -0.0
    d[3::6, 2] = 1e-25
    d[4::6, :2] = 0.0
    d[4::6, 2] = -1.0
    o[5::50, 0] = np.nan
    d[7, 2] = np.nan
    t_max = np.full(n, 1e4, np.float32)
    t_max[1::10] = np.inf
    t_max[2::10] = 0.0
    t_max[3::10] = -0.0
    t_max[4::10] = -1.0
    t_max[5::10] = np.nan
    t_max[6::10] = 15.0
    t_max[64:96] = -1.0  # a dead warp
    t_max[256:384] = np.where(np.arange(128) % 2, -2.0, np.nan)  # a dead block
    t = lambda x: torch.from_numpy(x).to(device)
    return woop._pack_rays(t(o), t(d), torch.zeros(n, device=device), t(t_max), woop.RAY_BLOCK)


def court(dev, fog=0.0):
    """The outdoor court (two alpha-tested grates, sky, sun, water; fog
    ``fog``), its accel and its 1080p config."""
    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import outdoor_court
    from merian_quake_tpu_torch.models.types import RenderConfig

    bundle = outdoor_court(fog, device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    if not feats.has_alpha_tris or accel.woop_w_alpha is None:
        raise AssertionError("the court has no alpha-tested triangles")
    return bundle, accel, RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL,
                                       features=feats)


# rays aimed at the live entities start this far from a triangle's centroid
AIM_DIST = 48.0


def aimed_rays(acc, n_static, n, seed):
    """``n`` rays aimed at the live entities: each starts AIM_DIST from a
    valid dynamic triangle's centroid and points at it."""
    s = acc.scene
    tris = s.valid[n_static:].nonzero()[:, 0] + n_static
    g = torch.Generator(device=tris.device).manual_seed(seed)
    pick = tris[torch.randint(0, tris.shape[0], (n,), device=tris.device, generator=g)]
    c = (s.v0[pick] + s.v1[pick] + s.v2[pick]) / 3.0
    u = torch.nn.functional.normalize(torch.randn((n, 3), device=c.device, generator=g), dim=-1)
    o = (c + AIM_DIST * u).contiguous()
    d = torch.nn.functional.normalize(c - o, dim=-1).contiguous()
    return o, d


def room_bsp() -> bytes:
    """A BSP29 file of a closed 512x512x256 room, built here (the port has
    no BSP writer): floor and three walls of plain textures, one wall of
    fullbright texels (the room's light), a sky ceiling, a
    worldspawn with a sun and an info_player_start. Every face is a quad
    whose plane normal points into the room."""
    import struct

    S, Z = 512.0, 256.0
    # (corners, inward normal, texture index, s axis, t axis)
    quads = [
        ([(0, 0, 0), (S, 0, 0), (S, S, 0), (0, S, 0)], (0, 0, 1), 0, (1, 0, 0), (0, 1, 0)),
        ([(0, 0, Z), (0, S, Z), (S, S, Z), (S, 0, Z)], (0, 0, -1), 2, (1, 0, 0), (0, 1, 0)),
        ([(0, 0, 0), (0, 0, Z), (S, 0, Z), (S, 0, 0)], (0, 1, 0), 1, (1, 0, 0), (0, 0, 1)),
        ([(0, S, 0), (S, S, 0), (S, S, Z), (0, S, Z)], (0, -1, 0), 1, (1, 0, 0), (0, 0, 1)),
        ([(0, 0, 0), (0, S, 0), (0, S, Z), (0, 0, Z)], (1, 0, 0), 3, (0, 1, 0), (0, 0, 1)),
        ([(S, 0, 0), (S, 0, Z), (S, S, Z), (S, S, 0)], (-1, 0, 0), 1, (0, 1, 0), (0, 0, 1)),
    ]
    pix = np.arange(256, dtype=np.uint8).reshape(16, 16)
    textures = [("floor1", (pix % 96).astype(np.uint8)), ("wall3", (pix // 2 + 16).astype(np.uint8)),
                ("sky4", (pix % 64 + 32).astype(np.uint8)),
                ("+0light", (224 + pix % 31).astype(np.uint8))]
    miptex = b""
    offsets = []
    for name, p in textures:
        offsets.append(4 + 4 * len(textures) + len(miptex))
        w, h = p.shape[1], p.shape[0]
        m0 = 40
        mips = (m0, m0 + w * h, m0 + w * h + w * h // 4, m0 + w * h + w * h // 4 + w * h // 16)
        miptex += name.encode().ljust(16, b"\0") + struct.pack("<ii", w, h) + struct.pack("<4i", *mips)
        miptex += p.tobytes() + bytes(w * h // 4 + w * h // 16 + w * h // 64)
    tex_lump = struct.pack(f"<i{len(textures)}i", len(textures), *offsets) + miptex
    planes, texinfo, verts, faces = b"", b"", [], b""
    edges, surfedges = [(0, 0)], []
    for q, (corners, normal, tex, s_ax, t_ax) in enumerate(quads):
        n = np.asarray(normal, np.float32)
        planes += struct.pack("<4fi", *n, float(np.dot(n, corners[0])), int(np.argmax(np.abs(n))))
        texinfo += struct.pack("<8f2i", *(np.asarray(s_ax) / 4.0), 0.0, *(np.asarray(t_ax) / 4.0),
                               0.0, tex, 0)
        first = len(surfedges)
        base = len(verts)
        verts += corners
        for k in range(4):
            surfedges.append(len(edges))
            edges.append((base + k, base + (k + 1) % 4))
        faces += struct.pack("<HHiHH4Bi", q, 0, first, 4, q, 0, 0, 0, 0, -1)
    entities = (b'{ "classname" "worldspawn" "_sunlight" "150" }\n'
                b'{ "classname" "info_player_start" "origin" "64 256 40" "angle" "0" }')
    lumps = {
        0: entities + b"\0", 1: planes, 2: tex_lump,
        3: np.asarray(verts, "<f4").tobytes(), 6: texinfo, 7: faces,
        12: np.asarray(edges, "<u2").tobytes(), 13: np.asarray(surfedges, "<i4").tobytes(),
        14: struct.pack("<9f7i", 0, 0, 0, S, S, Z, 0, 0, 0, 0, 0, 0, 0, 0, 0, len(quads)),
    }
    body, table, pos = b"", b"", 4 + 15 * 8
    for i in range(15):
        data = lumps.get(i, b"")
        table += struct.pack("<ii", pos, len(data))
        body += data
        pos += len(data)
    return struct.pack("<i", 29) + table + body
