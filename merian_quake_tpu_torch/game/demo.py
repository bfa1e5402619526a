"""Quake .dem demo playback (NetQuake protocol 15 subset).

Replaces the reference's demo playback path (quakespasm's CL_ReadDemo
feeding the same render callbacks; BASELINE config 3 uses 'e1m1 demo
playback'). A .dem is a CD-track line followed by blocks of
[i32 length][3×f32 view angles][server message bytes]; this parser
tracks what the camera path and entity placement need:

- svc_time / svc_setview / svc_setangle,
- svc_spawnbaseline + compressed entity updates (U_* bit deltas) for
  entity origins/angles/frames,
- svc_serverinfo (level name, model precache list),

and skips everything else by message-type-specific sizes. The output is
a frame-indexed sequence usable as a GameState camera path + entity
animation source. Tested against a synthetic writer; exotic messages
from mods may need additions.

Copy of merian_quake_tpu/game/demo.py (plain Python). The JAX package's
CLI has no demo command, and neither has the port's.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

# svc opcodes (protocol 15)
SVC_NOP = 1
SVC_DISCONNECT = 2
SVC_UPDATESTAT = 3
SVC_VERSION = 4
SVC_SETVIEW = 5
SVC_SOUND = 6
SVC_TIME = 7
SVC_PRINT = 8
SVC_STUFFTEXT = 9
SVC_SETANGLE = 10
SVC_SERVERINFO = 11
SVC_LIGHTSTYLE = 12
SVC_UPDATENAME = 13
SVC_UPDATEFRAGS = 14
SVC_CLIENTDATA = 15
SVC_STOPSOUND = 16
SVC_UPDATECOLORS = 17
SVC_PARTICLE = 18
SVC_DAMAGE = 19
SVC_SPAWNSTATIC = 20
SVC_SPAWNBASELINE = 22
SVC_TEMP_ENTITY = 23
SVC_SETPAUSE = 24
SVC_SIGNONNUM = 25
SVC_CENTERPRINT = 26
SVC_KILLEDMONSTER = 27
SVC_FOUNDSECRET = 28
SVC_SPAWNSTATICSOUND = 29
SVC_INTERMISSION = 30
SVC_FINALE = 31
SVC_CDTRACK = 32
SVC_SELLSCREEN = 33
SVC_CUTSCENE = 34

# entity update bits
U_MOREBITS = 1 << 0
U_ORIGIN1 = 1 << 1
U_ORIGIN2 = 1 << 2
U_ORIGIN3 = 1 << 3
U_ANGLE2 = 1 << 4
U_NOLERP = 1 << 5
U_FRAME = 1 << 6
U_SIGNAL = 1 << 7
U_ANGLE1 = 1 << 8
U_ANGLE3 = 1 << 9
U_MODEL = 1 << 10
U_COLORMAP = 1 << 11
U_SKIN = 1 << 12
U_EFFECTS = 1 << 13
U_LONGENTITY = 1 << 14

# clientdata bits
SU_VIEWHEIGHT = 1 << 0
SU_IDEALPITCH = 1 << 1
SU_PUNCH1 = 1 << 2
SU_PUNCH2 = 1 << 3
SU_PUNCH3 = 1 << 4
SU_VELOCITY1 = 1 << 5
SU_VELOCITY2 = 1 << 6
SU_VELOCITY3 = 1 << 7
SU_ITEMS = 1 << 9
SU_ONGROUND = 1 << 10
SU_INWATER = 1 << 11
SU_WEAPONFRAME = 1 << 12
SU_ARMOR = 1 << 13
SU_WEAPON = 1 << 14


@dataclass
class EntityState:
    model: int = 0
    frame: int = 0
    origin: tuple = (0.0, 0.0, 0.0)
    angles: tuple = (0.0, 0.0, 0.0)


@dataclass
class DemoFrame:
    time: float = 0.0
    view_angles: tuple = (0.0, 0.0, 0.0)
    view_entity: int = 1
    entities: dict = field(default_factory=dict)  # num → EntityState
    health: int = 100
    armor: int = 0


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def eof(self):
        return self.p >= len(self.d)

    def byte(self):
        v = self.d[self.p]
        self.p += 1
        return v

    def char(self):
        (v,) = struct.unpack_from("<b", self.d, self.p)
        self.p += 1
        return v

    def short(self):
        (v,) = struct.unpack_from("<h", self.d, self.p)
        self.p += 2
        return v

    def long(self):
        (v,) = struct.unpack_from("<i", self.d, self.p)
        self.p += 4
        return v

    def float32(self):
        (v,) = struct.unpack_from("<f", self.d, self.p)
        self.p += 4
        return v

    def coord(self):
        return self.short() / 8.0

    def angle(self):
        return self.char() * (360.0 / 256.0)

    def string(self):
        end = self.d.index(b"\0", self.p)
        s = self.d[self.p : end].decode("latin-1")
        self.p = end + 1
        return s


def parse_demo(data: bytes, max_frames: int | None = None):
    """Parse a .dem file → (level info dict, list of DemoFrame).

    A DemoFrame is emitted per demo block carrying an svc_time.
    """
    # CD track line (text up to \n)
    nl = data.index(b"\n")
    pos = nl + 1

    info = {"models": [], "map": "", "name": ""}
    baselines: dict[int, EntityState] = {}
    current = DemoFrame()
    frames: list[DemoFrame] = []

    while pos + 16 <= len(data):
        (length,) = struct.unpack_from("<i", data, pos)
        angles = struct.unpack_from("<fff", data, pos + 4)
        pos += 16
        if length <= 0 or pos + length > len(data):
            break
        r = _Reader(data[pos : pos + length])
        pos += length
        got_time = False
        while not r.eof():
            cmd = r.byte()
            if cmd & U_SIGNAL:  # compressed entity update
                bits = cmd & 0x7F
                if bits & U_MOREBITS:
                    bits |= r.byte() << 8
                num = r.short() if bits & U_LONGENTITY else r.byte()
                base = baselines.get(num, EntityState())
                ent = current.entities.get(num)
                if ent is None:
                    ent = EntityState(
                        model=base.model,
                        frame=base.frame,
                        origin=base.origin,
                        angles=base.angles,
                    )
                    current.entities[num] = ent
                if bits & U_MODEL:
                    ent.model = r.byte()
                if bits & U_FRAME:
                    ent.frame = r.byte()
                if bits & U_COLORMAP:
                    r.byte()
                if bits & U_SKIN:
                    r.byte()
                if bits & U_EFFECTS:
                    r.byte()
                o = list(ent.origin)
                a = list(ent.angles)
                if bits & U_ORIGIN1:
                    o[0] = r.coord()
                if bits & U_ANGLE1:
                    a[0] = r.angle()
                if bits & U_ORIGIN2:
                    o[1] = r.coord()
                if bits & U_ANGLE2:
                    a[1] = r.angle()
                if bits & U_ORIGIN3:
                    o[2] = r.coord()
                if bits & U_ANGLE3:
                    a[2] = r.angle()
                ent.origin = tuple(o)
                ent.angles = tuple(a)
                continue
            if cmd == SVC_NOP:
                continue
            if cmd == SVC_TIME:
                if got_time:
                    pass
                current.time = r.float32()
                current.view_angles = angles
                got_time = True
            elif cmd == SVC_SETVIEW:
                current.view_entity = r.short()
            elif cmd == SVC_SETANGLE:
                current.view_angles = (r.angle(), r.angle(), r.angle())
            elif cmd == SVC_SERVERINFO:
                r.long()  # protocol
                r.byte()  # maxclients
                r.byte()  # gametype
                info["name"] = r.string()
                models = []
                while True:
                    s = r.string()
                    if not s:
                        break
                    models.append(s)
                info["models"] = models
                info["map"] = models[0] if models else ""
                while r.string():  # sounds
                    pass
            elif cmd == SVC_SPAWNBASELINE or cmd == SVC_SPAWNSTATIC:
                num = r.short() if cmd == SVC_SPAWNBASELINE else -len(baselines) - 1
                st = EntityState()
                st.model = r.byte()
                st.frame = r.byte()
                r.byte()  # colormap
                r.byte()  # skin
                o, a = [0.0] * 3, [0.0] * 3
                for k in range(3):
                    o[k] = r.coord()
                    a[k] = r.angle()
                st.origin = tuple(o)
                st.angles = tuple(a)
                baselines[num] = st
            elif cmd == SVC_CLIENTDATA:
                bits = r.short()
                if bits & SU_VIEWHEIGHT:
                    r.char()
                if bits & SU_IDEALPITCH:
                    r.char()
                for k in range(3):
                    if bits & (SU_PUNCH1 << k):
                        r.char()
                    if bits & (SU_VELOCITY1 << k):
                        r.char()
                r.long()  # items
                if bits & SU_WEAPONFRAME:
                    r.byte()
                if bits & SU_ARMOR:
                    current.armor = r.byte()
                else:
                    current.armor = 0
                if bits & SU_WEAPON:
                    r.byte()
                current.health = r.short()
                r.byte()  # ammo
                for _ in range(4):
                    r.byte()  # shells nails rockets cells
                r.byte()  # active weapon
            elif cmd == SVC_UPDATESTAT:
                r.byte()
                r.long()
            elif cmd == SVC_VERSION:
                r.long()
            elif cmd == SVC_SOUND:
                fbits = r.byte()
                if fbits & 1:
                    r.byte()  # volume
                if fbits & 2:
                    r.byte()  # attenuation
                r.short()  # ent+channel
                r.byte()  # sound num
                for _ in range(3):
                    r.coord()
            elif cmd in (SVC_PRINT, SVC_STUFFTEXT, SVC_CENTERPRINT, SVC_FINALE, SVC_CUTSCENE):
                r.string()
            elif cmd == SVC_LIGHTSTYLE:
                r.byte()
                r.string()
            elif cmd == SVC_UPDATENAME:
                r.byte()
                r.string()
            elif cmd == SVC_UPDATEFRAGS:
                r.byte()
                r.short()
            elif cmd == SVC_STOPSOUND:
                r.short()
            elif cmd == SVC_UPDATECOLORS:
                r.byte()
                r.byte()
            elif cmd == SVC_PARTICLE:
                for _ in range(3):
                    r.coord()
                for _ in range(3):
                    r.char()
                r.byte()
                r.byte()
            elif cmd == SVC_DAMAGE:
                r.byte()
                r.byte()
                for _ in range(3):
                    r.coord()
            elif cmd == SVC_TEMP_ENTITY:
                t = r.byte()
                # common cases: point events (coord×3); beams add ent+2×coord3
                if t in (5, 6, 9, 13):  # lightning/beam
                    r.short()
                    for _ in range(6):
                        r.coord()
                else:
                    for _ in range(3):
                        r.coord()
            elif cmd == SVC_SETPAUSE:
                r.byte()
            elif cmd == SVC_SIGNONNUM:
                r.byte()
            elif cmd == SVC_SPAWNSTATICSOUND:
                for _ in range(3):
                    r.coord()
                r.byte()
                r.byte()
                r.byte()
            elif cmd == SVC_CDTRACK:
                r.byte()
                r.byte()
            elif cmd in (SVC_KILLEDMONSTER, SVC_FOUNDSECRET, SVC_SELLSCREEN,
                         SVC_INTERMISSION, SVC_DISCONNECT):
                pass
            else:
                # unknown message: cannot skip safely — stop this block
                break
        if got_time:
            # snapshot: copy entity dict (states are mutated in place)
            snap = DemoFrame(
                time=current.time,
                view_angles=current.view_angles,
                view_entity=current.view_entity,
                entities={
                    k: EntityState(e.model, e.frame, e.origin, e.angles)
                    for k, e in current.entities.items()
                },
                health=current.health,
                armor=current.armor,
            )
            frames.append(snap)
            if max_frames and len(frames) >= max_frames:
                break
    return info, frames


def demo_camera_path(frames: list[DemoFrame], eye_height: float = 22.0):
    """Camera path callable t → (pos, fwd, up) interpolating demo frames
    (usable as GameState.camera_path)."""
    import numpy as np

    times = np.asarray([f.time for f in frames])
    origins = np.asarray(
        [f.entities.get(f.view_entity, EntityState()).origin for f in frames],
        np.float32,
    ) + np.asarray([0, 0, eye_height], np.float32)
    angs = np.asarray([f.view_angles for f in frames], np.float32)

    def path(t):
        i = int(np.clip(np.searchsorted(times, t) - 1, 0, len(frames) - 2))
        w = 0.0
        dt = times[i + 1] - times[i]
        if dt > 1e-9:
            w = float(np.clip((t - times[i]) / dt, 0.0, 1.0))
        pos = origins[i] * (1 - w) + origins[i + 1] * w
        a = angs[i] * (1 - w) + angs[i + 1] * w
        pitch, yaw = np.deg2rad(a[0]), np.deg2rad(a[1])
        fwd = np.asarray(
            [
                np.cos(yaw) * np.cos(-pitch),
                np.sin(yaw) * np.cos(-pitch),
                np.sin(-pitch),
            ],
            np.float32,
        )
        return pos, fwd, np.asarray([0.0, 0.0, 1.0], np.float32)

    return path
