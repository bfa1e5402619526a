"""Live AD-scale dungeon: the map-scale end-to-end benchmark game.

Wires models/dungeon.py's generated map (geometry + matching collision
hulls + entity lump) into the native game host with the packaged mod's
progs (walker monsters, torch flames) — the live equivalent of the
reference's e1m1/AD test setup (quakedir/id1/autoexec.cfg;
quake_node.cpp:896-1012 per-frame dynamic geometry under real entity
load). Rendering should use the incremental accel
(accel/build.py build_accel_live + refresh_dynamic), not a per-frame
full rebuild.

Copy of merian_quake_tpu/game/bigmap.py; ``make_bigmap`` takes
``device=`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

from .host import QuakeHost, WorldHulls
from .live import LiveGame
from .mod import (
    BALL_MDL,
    DOOR_MDL,
    FLAME_SPR,
    WALKER_MDL,
    ball_model,
    build_progs,
    door_model,
    flame_sprite,
    walker_model,
)


def make_bigmap(
    seed: int = 3,
    grid: int = 8,
    monsters: int = 32,
    dynamic_capacity: int = 4096,
    detail: int = 1,
    device="cuda",
):
    """Boot the live dungeon; returns (LiveGame, DungeonBundle)."""
    from ..models.dungeon import dungeon

    d = dungeon(seed=seed, grid=grid, monsters=monsters, detail=detail, device=device)
    host = QuakeHost(max_edicts=1024)
    host.load_progs(build_progs())
    host.load_world(
        WorldHulls.room(d.bounds[0], d.bounds[1], boxes=d.hull_boxes)
    )
    host.set_model_bounds(BALL_MDL, (-12, -12, -12), (12, 12, 12))
    host.set_model_bounds(WALKER_MDL, (-16, -16, -24), (16, 16, 26))
    host.set_model_bounds(DOOR_MDL, (-8, -48, 0), (8, 48, 112))
    host.spawn(d.entity_lump, mapname="maps/dungeon.bsp")
    models = {
        BALL_MDL: ball_model(),
        WALKER_MDL: walker_model(),
        FLAME_SPR: flame_sprite(),
        DOOR_MDL: door_model(),
    }
    live = LiveGame(
        host, d.bundle, models, dynamic_capacity=dynamic_capacity, device=device
    )
    return live, d
