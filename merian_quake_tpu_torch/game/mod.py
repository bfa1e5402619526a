"""Packaged demo game mod: a live-simulated arena the framework can
render end-to-end without shipping id1 assets.

The reference plays real Quake maps through the embedded quakespasm
(`quakedir/id1/autoexec.cfg` boots e1m1); its PAKs aren't
redistributable, so the framework ships this miniature-but-real mod
instead: QuakeC progs assembled by game/qcasm.py, a cornell-box world
with matching collision hulls, and procedural alias/sprite models. It
exercises the full live path — server physics (bounce/step/walk), think
chains, triggers + centerprints, QC particle effects, lightstyles,
makestatic — through exactly the same LiveGame seam a real progs.dat
would use.

Copy of merian_quake_tpu/game/mod.py; ``make_arena`` takes ``device=``
(the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import numpy as np

from .host import QuakeHost, WorldHulls
from .live import LiveGame
from .qcasm import (
    EV_FLOAT, OP_ADD_F, OP_ADDRESS, OP_BITAND, OP_GT, OP_IF, OP_IFNOT,
    OP_LOAD_F, OP_LOAD_V, OP_LT, OP_MUL_F, OP_STOREP_ENT, OP_STOREP_F,
    OP_STOREP_FNC, OP_SUB_F, OP_SUB_V, QCAsm,
)
from ..models.mdl import AliasModel, load_mdl, write_mdl
from ..models.procedural import cornell_box
from ..models.spr import load_spr, write_spr

MOVETYPE_WALK, MOVETYPE_STEP, MOVETYPE_TOSS = 3.0, 4.0, 6.0
MOVETYPE_PUSH = 7.0
MOVETYPE_BOUNCE = 10.0
SOLID_TRIGGER, SOLID_BBOX, SOLID_SLIDEBOX = 1.0, 2.0, 3.0
FL_ONGROUND = 512.0

BALL_MDL = "progs/ball.mdl"
WALKER_MDL = "progs/walker.mdl"
FLAME_SPR = "progs/flame.spr"
DOOR_MDL = "progs/door.mdl"

# func_door parameters (speed u/s, travel units)
DOOR_SPEED, DOOR_TRAVEL, DOOR_WAIT = 80.0, 104.0, 2.0


# ---------------------------------------------------------------- models
def ball_model(radius: float = 12.0) -> AliasModel:
    """Bouncy octahedron with a squash keyframe."""
    r = radius
    verts = np.asarray(
        [[r, 0, 0], [-r, 0, 0], [0, r, 0], [0, -r, 0], [0, 0, r],
         [0, 0, -r]],
        np.float32,
    )
    tris = np.asarray(
        [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
         [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]],
        np.int32,
    )
    squash = verts * np.asarray([1.2, 1.2, 0.65], np.float32)
    frames = np.stack([verts, squash])
    # skin: bright orange with a fullbright stripe (palette rows)
    skin = np.full((16, 16), 73, np.uint8)  # orange ramp
    skin[6:10] = 251  # fullbright yellow stripe
    sw, sh = 16, 16
    uv_s = np.clip(
        ((verts[:, 0] + r) / (2 * r) * (sw - 1)), 0, sw - 1
    ).astype(np.int64)
    uv_t = np.clip(
        ((verts[:, 1] + r) / (2 * r) * (sh - 1)), 0, sh - 1
    ).astype(np.int64)
    lo = frames.min(axis=(0, 1))
    scale = (frames.max(axis=(0, 1)) - lo) / 254.0 + 1e-6
    blob = write_mdl(
        [skin], uv_s, uv_t, np.zeros(len(verts), np.int64), tris,
        np.ones(len(tris), np.int64), frames, scale.astype(np.float32),
        lo.astype(np.float32),
    )
    return load_mdl(blob, "ball")


def walker_model() -> AliasModel:
    """Minimal biped: torso box + head, 2-frame waddle."""
    def box(cx, cy, z0, z1, hw, hd):
        return np.asarray(
            [[cx - hw, cy - hd, z0], [cx + hw, cy - hd, z0],
             [cx + hw, cy + hd, z0], [cx - hw, cy + hd, z0],
             [cx - hw, cy - hd, z1], [cx + hw, cy - hd, z1],
             [cx + hw, cy + hd, z1], [cx - hw, cy + hd, z1]],
            np.float32,
        )

    def box_tris(b):
        quads = [(0, 1, 2, 3), (7, 6, 5, 4), (0, 4, 5, 1), (1, 5, 6, 2),
                 (2, 6, 7, 3), (3, 7, 4, 0)]
        return [(b + q[0], b + q[1], b + q[2]) for q in quads] + [
            (b + q[0], b + q[2], b + q[3]) for q in quads
        ]

    torso = box(0, 0, -24, 14, 10, 8)
    head = box(0, 0, 14, 26, 6, 6)
    verts = np.concatenate([torso, head])
    tris = np.asarray(box_tris(0) + box_tris(8), np.int32)
    # waddle: shear the torso top and bob the head
    f1 = verts.copy()
    f1[4:8, 1] += 4.0  # torso top leans
    f1[8:, 2] -= 2.0  # head bobs
    f1[8:, 1] += 4.0
    frames = np.stack([verts, f1])
    skin = np.full((16, 16), 112, np.uint8)  # olive ramp
    skin[2:6, 4:12] = 247  # fullbright eyes band
    uv_s = np.clip(
        (verts[:, 0] + 10) / 20.0 * 15, 0, 15
    ).astype(np.int64)
    uv_t = np.clip(
        (26 - verts[:, 2]) / 50.0 * 15, 0, 15
    ).astype(np.int64)
    lo = frames.min(axis=(0, 1))
    scale = (frames.max(axis=(0, 1)) - lo) / 254.0 + 1e-6
    blob = write_mdl(
        [skin], uv_s, uv_t, np.zeros(len(verts), np.int64), tris,
        np.ones(len(tris), np.int64), frames, scale.astype(np.float32),
        lo.astype(np.float32),
    )
    return load_mdl(blob, "walker")


def door_model() -> AliasModel:
    """Sliding door slab (func_door equivalent): 16×96×112, one frame.

    Real maps implement doors as BSP submodels; the packaged arena uses
    an alias-model pusher with the same QC movement chain (trigger →
    rise → wait → return) so the door/plat builtin surface a real
    progs.dat exercises (ltime-based pusher thinks, MOVETYPE_PUSH) is
    driven end-to-end."""
    hw, hd, hh = 8.0, 48.0, 112.0
    verts = np.asarray(
        [[-hw, -hd, 0], [hw, -hd, 0], [hw, hd, 0], [-hw, hd, 0],
         [-hw, -hd, hh], [hw, -hd, hh], [hw, hd, hh], [-hw, hd, hh]],
        np.float32,
    )
    quads = [(0, 1, 2, 3), (7, 6, 5, 4), (0, 4, 5, 1), (1, 5, 6, 2),
             (2, 6, 7, 3), (3, 7, 4, 0)]
    tris = np.asarray(
        [(q[0], q[1], q[2]) for q in quads]
        + [(q[0], q[2], q[3]) for q in quads],
        np.int32,
    )
    frames = verts[None]
    skin = np.full((16, 16), 2, np.uint8)  # gray ramp
    skin[7:9, :] = 10  # accent stripe
    uv_s = np.clip((verts[:, 1] + hd) / (2 * hd) * 15, 0, 15).astype(
        np.int64
    )
    uv_t = np.clip((hh - verts[:, 2]) / hh * 15, 0, 15).astype(np.int64)
    lo = frames.min(axis=(0, 1))
    scale = (frames.max(axis=(0, 1)) - lo) / 254.0 + 1e-6
    blob = write_mdl(
        [skin], uv_s, uv_t, np.zeros(len(verts), np.int64), tris,
        np.ones(len(tris), np.int64), frames, scale.astype(np.float32),
        lo.astype(np.float32),
    )
    return load_mdl(blob, "door")


def flame_sprite():
    """Two-frame torch flame (fullbright palette rows)."""
    rng = np.random.default_rng(7)
    frames = []
    for _ in range(2):
        pix = np.zeros((24, 16), np.uint8)
        for y in range(24):
            w = max(1, int(7 * (1.0 - y / 24.0) + rng.integers(0, 2)))
            pix[23 - y, 8 - w: 8 + w] = 244 + (y // 6)  # fire ramp
        frames.append(pix)
    return load_spr(write_spr(frames), "flame")


# ---------------------------------------------------------------- progs
def _sfield(fn, asm, ent, field, src, vec=False):
    ptr = fn.temp()
    fn.emit(OP_ADDRESS, ent, asm.field_const(field), ptr)
    fn.emit(OP_STOREP_F if not vec else OP_STOREP_F + 1, src, ptr)


def _lfield(fn, asm, ent, field, vec=False):
    dst = fn.temp(3 if vec else 1)
    fn.emit(OP_LOAD_V if vec else OP_LOAD_F, ent, asm.field_const(field), dst)
    return dst


def _schedule(fn, asm, think_name, delay):
    t = fn.temp()
    fn.emit(OP_ADD_F, asm["time"], asm.float_const(delay), t)
    _sfield(fn, asm, asm["self"], "nextthink", t)
    ptr = fn.temp()
    fn.emit(OP_ADDRESS, asm["self"], asm.field_const("think"), ptr)
    fn.emit(OP_STOREP_FNC, asm.fn_global(think_name), ptr)


def _rand_centered(fn, asm, scale):
    """temp = (random() - 0.5) * scale"""
    t = fn.temp()
    fn.call("random", ret=t)
    fn.emit(OP_SUB_F, t, asm.float_const(0.5), t)
    fn.emit(OP_MUL_F, t, asm.float_const(scale), t)
    return t


def build_progs() -> bytes:
    """The arena's game code (see module docstring)."""
    asm = QCAsm()
    # mod-specific entity fields (standard fields are predeclared)
    asm.field("attack_finished", EV_FLOAT)
    asm.field("state", EV_FLOAT)

    w = asm.function("worldspawn")
    w.call("precache_model", (asm.string_const(BALL_MDL), 1))
    w.call("precache_model", (asm.string_const(WALKER_MDL), 1))
    w.call("precache_model", (asm.string_const(FLAME_SPR), 1))
    w.call("precache_model", (asm.string_const(DOOR_MDL), 1))
    w.call("precache_sound", (asm.string_const("misc/secret.wav"), 1))
    w.call("precache_sound", (asm.string_const("walker/bite.wav"), 1))
    w.call("precache_sound", (asm.string_const("doors/stone1.wav"), 1))
    w.call("lightstyle", asm.float_const(0.0), (asm.string_const("m"), 1))
    w.call(
        "lightstyle", asm.float_const(1.0),
        (asm.string_const("mmnmmommommnonmmonqnmmo"), 1),
    )
    w.ret()

    asm.function("info_player_start").ret()

    # bouncing ball: BOUNCE physics + a periodic random kick
    kick = asm.function("ball_kick")
    vz = kick.temp()
    kick.call("random", ret=vz)
    kick.emit(OP_MUL_F, vz, asm.float_const(120.0), vz)
    kick.emit(OP_ADD_F, vz, asm.float_const(280.0), vz)
    _sfield(kick, asm, asm["self"], "velocity_z", vz)
    _sfield(kick, asm, asm["self"], "velocity_x",
            _rand_centered(kick, asm, 260.0))
    _sfield(kick, asm, asm["self"], "velocity_y",
            _rand_centered(kick, asm, 260.0))
    _schedule(kick, asm, "ball_kick", 2.5)
    kick.ret()

    ball = asm.function("item_ball")
    _sfield(ball, asm, asm["self"], "movetype",
            asm.float_const(MOVETYPE_BOUNCE))
    _sfield(ball, asm, asm["self"], "solid", asm.float_const(SOLID_BBOX))
    ball.call("setmodel", asm["self"], (asm.string_const(BALL_MDL), 1))
    ball.call("setsize", asm["self"], (asm.vector_const(-12, -12, -12), 3),
              (asm.vector_const(12, 12, 12), 3))
    _schedule(ball, asm, "ball_kick", 1.0)
    ball.ret()

    # patrolling walker: STEP physics, 2-frame anim; within sight range
    # it becomes a CHASING, BITING monster — the combat AI loop a real
    # progs.dat drives (checkclient → vectoyaw/ChangeYaw → movetogoal →
    # melee damage + sound + sprint + blood particles)
    wt = asm.function("walker_think")
    fr = _lfield(wt, asm, asm["self"], "frame")
    wt.emit(OP_SUB_F, asm.float_const(1.0), fr, fr)
    _sfield(wt, asm, asm["self"], "frame", fr)
    e = wt.temp()
    wt.call("checkclient", ret=e)
    j_noclient = wt.emit(OP_IFNOT, e, 0)
    eo = _lfield(wt, asm, e, "origin", vec=True)
    so = _lfield(wt, asm, asm["self"], "origin", vec=True)
    diff = wt.temp(3)
    wt.emit(OP_SUB_V, eo, so, diff)
    dist = wt.temp()
    wt.call("vlen", (diff, 3), ret=dist)
    far = wt.temp()
    wt.emit(OP_GT, dist, asm.float_const(150.0), far)
    j_far = wt.emit(OP_IF, far, 0)
    # ---- chase ----
    eptr = wt.temp()
    wt.emit(OP_ADDRESS, asm["self"], asm.field_const("enemy"), eptr)
    wt.emit(OP_STOREP_ENT, e, eptr)
    gptr = wt.temp()
    wt.emit(OP_ADDRESS, asm["self"], asm.field_const("goalentity"), gptr)
    wt.emit(OP_STOREP_ENT, e, gptr)
    iy = wt.temp()
    wt.call("vectoyaw", (diff, 3), ret=iy)
    _sfield(wt, asm, asm["self"], "ideal_yaw", iy)
    _sfield(wt, asm, asm["self"], "yaw_speed", asm.float_const(20.0))
    wt.call("ChangeYaw")
    wt.call("movetogoal", asm.float_const(8.0))
    # ---- melee when adjacent and off cooldown ----
    near = wt.temp()
    wt.emit(OP_LT, dist, asm.float_const(64.0), near)
    j_notnear = wt.emit(OP_IFNOT, near, 0)
    af = _lfield(wt, asm, asm["self"], "attack_finished")
    cool = wt.temp()
    wt.emit(OP_LT, af, asm["time"], cool)
    j_cooling = wt.emit(OP_IFNOT, cool, 0)
    naf = wt.temp()
    wt.emit(OP_ADD_F, asm["time"], asm.float_const(1.2), naf)
    _sfield(wt, asm, asm["self"], "attack_finished", naf)
    wt.call("sound", asm["self"], asm.float_const(1.0),
            (asm.string_const("walker/bite.wav"), 1),
            asm.float_const(1.0), asm.float_const(1.0))
    wt.call("sprint", e, (asm.string_const("the walker bites!"), 1))
    hp = _lfield(wt, asm, e, "health")
    wt.emit(OP_SUB_F, hp, asm.float_const(4.0), hp)
    _sfield(wt, asm, e, "health", hp)
    wt.call("particle", (eo, 3), (asm.vector_const(0, 0, 1), 3),
            asm.float_const(73.0), asm.float_const(12.0))
    chase_end = wt.label()
    wt.patch_goto(j_notnear, chase_end)
    wt.patch_goto(j_cooling, chase_end)
    _schedule(wt, asm, "walker_think", 0.1)
    wt.ret()
    # ---- patrol (circle walk) ----
    patrol = wt.label()
    wt.patch_goto(j_noclient, patrol)
    wt.patch_goto(j_far, patrol)
    yawv = _lfield(wt, asm, asm["self"], "angles_y")
    wt.emit(OP_ADD_F, yawv, asm.float_const(10.0), yawv)
    _sfield(wt, asm, asm["self"], "angles_y", yawv)
    wt.call("walkmove", yawv, asm.float_const(10.0))
    _schedule(wt, asm, "walker_think", 0.1)
    wt.ret()

    wk = asm.function("monster_walker")
    _sfield(wk, asm, asm["self"], "movetype",
            asm.float_const(MOVETYPE_STEP))
    _sfield(wk, asm, asm["self"], "solid", asm.float_const(SOLID_SLIDEBOX))
    wk.call("setmodel", asm["self"], (asm.string_const(WALKER_MDL), 1))
    wk.call("setsize", asm["self"], (asm.vector_const(-16, -16, -24), 3),
            (asm.vector_const(16, 16, 26), 3))
    wk.call("droptofloor")
    _schedule(wk, asm, "walker_think", 0.3)
    wk.ret()

    # ---- func_door chain (doors/plats builtin surface): ltime-based
    # pusher thinks (PhysicsPusher), trigger → rise → wait → return ----
    def _schedule_ltime(fn, ent, think_name, delay):
        lt = _lfield(fn, asm, ent, "ltime")
        fn.emit(OP_ADD_F, lt, asm.float_const(delay), lt)
        _sfield(fn, asm, ent, "nextthink", lt)
        ptr = fn.temp()
        fn.emit(OP_ADDRESS, ent, asm.field_const("think"), ptr)
        fn.emit(OP_STOREP_FNC, asm.fn_global(think_name), ptr)

    travel_t = DOOR_TRAVEL / DOOR_SPEED
    db = asm.function("door_bottom")
    _sfield(db, asm, asm["self"], "velocity_z", asm.float_const(0.0))
    _sfield(db, asm, asm["self"], "state", asm.float_const(0.0))
    db.ret()

    dd = asm.function("door_down")
    _sfield(dd, asm, asm["self"], "velocity_z",
            asm.float_const(-DOOR_SPEED))
    _schedule_ltime(dd, asm["self"], "door_bottom", travel_t)
    dd.ret()

    dt_ = asm.function("door_top")
    _sfield(dt_, asm, asm["self"], "velocity_z", asm.float_const(0.0))
    _schedule_ltime(dt_, asm["self"], "door_down", DOOR_WAIT)
    dt_.ret()

    dzt = asm.function("door_zone_touch")
    d_ent = dzt.temp()
    dzt.call("find", asm["world"], (asm.field_const("classname"), 1),
             (asm.string_const("func_door_slab"), 1), ret=d_ent)
    j_nodoor = dzt.emit(OP_IFNOT, d_ent, 0)
    st = _lfield(dzt, asm, d_ent, "state")
    j_busy = dzt.emit(OP_IF, st, 0)
    _sfield(dzt, asm, d_ent, "state", asm.float_const(1.0))
    _sfield(dzt, asm, d_ent, "velocity_z", asm.float_const(DOOR_SPEED))
    _schedule_ltime(dzt, d_ent, "door_top", travel_t)
    dzt.call("sound", d_ent, asm.float_const(1.0),
             (asm.string_const("doors/stone1.wav"), 1),
             asm.float_const(1.0), asm.float_const(1.0))
    end_d = dzt.label()
    dzt.patch_goto(j_nodoor, end_d)
    dzt.patch_goto(j_busy, end_d)
    dzt.ret()

    door = asm.function("func_door_slab")
    _sfield(door, asm, asm["self"], "movetype",
            asm.float_const(MOVETYPE_PUSH))
    _sfield(door, asm, asm["self"], "solid", asm.float_const(SOLID_BBOX))
    door.call("setmodel", asm["self"], (asm.string_const(DOOR_MDL), 1))
    door.call("setsize", asm["self"],
              (asm.vector_const(-8, -48, 0), 3),
              (asm.vector_const(8, 48, 112), 3))
    _sfield(door, asm, asm["self"], "state", asm.float_const(0.0))
    door.ret()

    dzone = asm.function("trigger_door_zone")
    _sfield(dzone, asm, asm["self"], "solid",
            asm.float_const(SOLID_TRIGGER))
    dptr = dzone.temp()
    dzone.emit(OP_ADDRESS, asm["self"], asm.field_const("touch"), dptr)
    dzone.emit(OP_STOREP_FNC, asm.fn_global("door_zone_touch"), dptr)
    dzone.call("setsize", asm["self"],
               (asm.vector_const(-56, -56, -48), 3),
               (asm.vector_const(56, 56, 48), 3))
    dzone.ret()

    # ---- trigger_changelevel (the level-exit builtin surface) ----
    ext = asm.function("exit_touch")
    ext.call("changelevel", (asm.string_const("arena2"), 1))
    ext.ret()

    ezone = asm.function("trigger_exit_zone")
    _sfield(ezone, asm, asm["self"], "solid",
            asm.float_const(SOLID_TRIGGER))
    eptr2 = ezone.temp()
    ezone.emit(OP_ADDRESS, asm["self"], asm.field_const("touch"), eptr2)
    ezone.emit(OP_STOREP_FNC, asm.fn_global("exit_touch"), eptr2)
    ezone.call("setsize", asm["self"],
               (asm.vector_const(-40, -40, -48), 3),
               (asm.vector_const(40, 40, 48), 3))
    ezone.ret()

    # static torch flame (QC makestatic → cl_static_entities path)
    lt = asm.function("light_torch")
    lt.call("setmodel", asm["self"], (asm.string_const(FLAME_SPR), 1))
    lt.call("makestatic", asm["self"])
    lt.ret()

    # secret zone: touch → centerprint + sound + particles, 1.5 s gate
    zt = asm.function("zone_touch")
    now_lt = zt.temp()
    tt = _lfield(zt, asm, asm["self"], "teleport_time")
    zt.emit(OP_LT, asm["time"], tt, now_lt)
    j = zt.emit(OP_IFNOT, now_lt, 0)
    zt.ret()  # gated: fired recently
    zt.patch_goto(j, zt.label())
    gate = zt.temp()
    zt.emit(OP_ADD_F, asm["time"], asm.float_const(1.5), gate)
    _sfield(zt, asm, asm["self"], "teleport_time", gate)
    zt.call("centerprint", asm["other"],
            (asm.string_const("You found the secret!"), 1))
    zt.call("sound", asm["self"], asm.float_const(1.0),
            (asm.string_const("misc/secret.wav"), 1), asm.float_const(1.0),
            asm.float_const(1.0))
    org = _lfield(zt, asm, asm["self"], "origin", vec=True)
    zt.call("particle", (org, 3), (asm.vector_const(0, 0, 2), 3),
            asm.float_const(73.0), asm.float_const(24.0))
    zt.ret()

    zone = asm.function("trigger_secret_zone")
    _sfield(zone, asm, asm["self"], "solid",
            asm.float_const(SOLID_TRIGGER))
    ptr = zone.temp()
    zone.emit(OP_ADDRESS, asm["self"], asm.field_const("touch"), ptr)
    zone.emit(OP_STOREP_FNC, asm.fn_global("zone_touch"), ptr)
    zone.call("setsize", asm["self"], (asm.vector_const(-80, -80, -48), 3),
              (asm.vector_const(80, 80, 48), 3))
    zone.ret()

    # client
    pcis = asm.function("PutClientInServer")
    _sfield(pcis, asm, asm["self"], "movetype",
            asm.float_const(MOVETYPE_WALK))
    _sfield(pcis, asm, asm["self"], "solid",
            asm.float_const(SOLID_SLIDEBOX))
    _sfield(pcis, asm, asm["self"], "health", asm.float_const(100.0))
    _sfield(pcis, asm, asm["self"], "armorvalue", asm.float_const(30.0))
    spot = pcis.temp()
    pcis.call("find", asm["world"], (asm.field_const("classname"), 1),
              (asm.string_const("info_player_start"), 1), ret=spot)
    sorg = _lfield(pcis, asm, spot, "origin", vec=True)
    pcis.call("setorigin", asm["self"], (sorg, 3))
    pcis.call("setsize", asm["self"], (asm.vector_const(-16, -16, -24), 3),
              (asm.vector_const(16, 16, 32), 3))
    ptrv = pcis.temp()
    pcis.emit(OP_ADDRESS, asm["self"], asm.field_const("view_ofs_z"), ptrv)
    pcis.emit(OP_STOREP_F, asm.float_const(22.0), ptrv)
    pcis.ret()

    # jump handling (id1 PlayerJump essence)
    pre = asm.function("PlayerPreThink")
    b2 = _lfield(pre, asm, asm["self"], "button2")
    j1 = pre.emit(OP_IFNOT, b2, 0)
    fl = _lfield(pre, asm, asm["self"], "flags")
    og = pre.temp()
    pre.emit(OP_BITAND, fl, asm.float_const(FL_ONGROUND), og)
    j2 = pre.emit(OP_IFNOT, og, 0)
    vz2 = _lfield(pre, asm, asm["self"], "velocity_z")
    pre.emit(OP_ADD_F, vz2, asm.float_const(270.0), vz2)
    _sfield(pre, asm, asm["self"], "velocity_z", vz2)
    end = pre.label()
    pre.patch_goto(j1, end)
    pre.patch_goto(j2, end)
    pre.ret()

    asm.function("PlayerPostThink").ret()
    asm.function("StartFrame").ret()
    asm.function("SetNewParms").ret()
    asm.function("ClientConnect").ret()
    return asm.build()


ENTITY_LUMP = """
{
"classname" "worldspawn"
"message" "the arena"
}
{
"classname" "info_player_start"
"origin" "64 256 25"
}
{
"classname" "item_ball"
"origin" "180 256 120"
}
{
"classname" "monster_walker"
"origin" "256 380 26"
}
{
"classname" "light_torch"
"origin" "52 52 120"
}
{
"classname" "trigger_secret_zone"
"origin" "256 140 48"
}
{
"classname" "func_door_slab"
"origin" "470 80 0"
}
{
"classname" "trigger_door_zone"
"origin" "420 80 40"
}
{
"classname" "trigger_exit_zone"
"origin" "64 64 40"
}
"""


# ---------------------------------------------------------------- world
def arena_hulls() -> WorldHulls:
    """Collision matching models/procedural.py cornell_box: the 512³/2
    room with its two blocks as solid obstacles."""
    return WorldHulls.room(
        (0, 0, 0), (512, 512, 256),
        boxes=[
            ((300, 290, 0), (390, 380, 120)),
            ((260, 120, 0), (340, 200, 60)),
        ],
    )


def make_arena(dynamic_capacity: int = 1024, emission: float = 16.0,
               max_edicts: int = 256, device="cuda") -> LiveGame:
    """Boot the live arena: host + world + models + LiveGame bridge."""
    host = QuakeHost(max_edicts=max_edicts)
    host.load_progs(build_progs())
    host.load_world(arena_hulls())
    host.set_model_bounds(BALL_MDL, (-12, -12, -12), (12, 12, 12))
    host.set_model_bounds(WALKER_MDL, (-16, -16, -24), (16, 16, 26))
    host.set_model_bounds(DOOR_MDL, (-8, -48, 0), (8, 48, 112))
    host.spawn(ENTITY_LUMP, mapname="maps/arena.bsp")
    models = {
        BALL_MDL: ball_model(),
        WALKER_MDL: walker_model(),
        FLAME_SPR: flame_sprite(),
        DOOR_MDL: door_model(),
    }
    return LiveGame(
        host, cornell_box(emission=emission, device=device), models,
        dynamic_capacity=dynamic_capacity, device=device,
    )
