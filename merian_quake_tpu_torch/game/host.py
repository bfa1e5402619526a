"""Live game simulation host (ctypes bridge to native/game/).

Copy of merian_quake_tpu/game/host.py with its own build of the native
library. The reference embeds quakespasm and drives it with
Host_Init/Host_Frame from a dedicated game thread (quake_node.cpp:39-76,
460-491); the renderer pulls entity state through extern "C" callbacks
each frame (quake_node.cpp:80-229). This wrapper is the same seam,
inverted into a frame-indexed pull API: the native host runs the
QuakeC progs VM, BSP hull collision and server physics (native/game/),
and ``QuakeHost`` exposes per-frame entity snapshots, player view state,
HUD stats, lightstyles and event streams (sounds/particles/prints).

The library is built here, at first use, with ``g++`` from the sources
``native/game/*.cc`` (read, never written) and native/Makefile's flags,
into ``merian_quake_tpu_torch/_build/``; its file name carries a hash of
the sources, headers and flags, so an edited source is rebuilt and a
stale library is never loaded. The tracked ``native/libmq_game.so`` is
neither loaded nor rebuilt. A failed build raises with the compiler's
output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GAME_SRC_DIR = os.path.join(_REPO, "native", "game")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
# native/Makefile's GAME_SRCS and CXXFLAGS
GAME_SRCS = ("progs.cc", "world.cc", "host.cc", "builtins.cc", "save.cc", "api.cc")
GAME_HDRS = ("progs.h", "world.h", "host.h")
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread", "-Wall")

_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_i32_p = ctypes.POINTER(ctypes.c_int32)
_c_u8_p = ctypes.POINTER(ctypes.c_uint8)


def _cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the game host library is built from native/game/*.cc")
    return found


def library_path() -> str:
    """Where the game host library of this checkout's sources lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for f in (*GAME_SRCS, *GAME_HDRS):
        with open(os.path.join(GAME_SRC_DIR, f), "rb") as src:
            h.update(f.encode() + src.read())
    return os.path.join(BUILD_DIR, f"libmq_game_{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile native/game/*.cc into ``_build/`` if this checkout's build
    is not there yet (one ``g++`` a source, all started together, then
    the link); returns the library's path. Raises with the compiler's
    output if the build fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{f}.o" for f in GAME_SRCS]

    def run(cmds):
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True)) for cmd in cmds]
        failed = []
        for cmd, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{err}")
        if failed:
            raise RuntimeError("building the game host failed: " + "\n".join(failed))

    try:
        run([[_cxx(), *CXXFLAGS, "-c", "-o", o, os.path.join(GAME_SRC_DIR, f)]
             for f, o in zip(GAME_SRCS, objs)])
        run([[_cxx(), *CXXFLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    os.replace(tmp, so)
    return so


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library())
    lib.mq_game_create.restype = ctypes.c_void_p
    lib.mq_game_load_progs.argtypes = [
        ctypes.c_void_p, _c_u8_p, ctypes.c_longlong, ctypes.c_int]
    lib.mq_game_load_world.argtypes = [
        ctypes.c_void_p, _c_float_p, ctypes.c_int, _c_i32_p, ctypes.c_int,
        _c_i32_p, _c_float_p, ctypes.c_int]
    lib.mq_game_set_model_bounds.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, _c_float_p, _c_float_p]
    lib.mq_game_set_cvar.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_float]
    lib.mq_game_cvar.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mq_game_cvar.restype = ctypes.c_float
    lib.mq_game_spawn_server.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
    lib.mq_game_spawn_client.argtypes = [ctypes.c_void_p]
    lib.mq_game_set_usercmd.argtypes = [
        ctypes.c_void_p] + [ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_int]
    lib.mq_game_frame.argtypes = [ctypes.c_void_p, ctypes.c_float]
    lib.mq_game_time.argtypes = [ctypes.c_void_p]
    lib.mq_game_time.restype = ctypes.c_float
    lib.mq_game_player.argtypes = [ctypes.c_void_p]
    lib.mq_game_error.argtypes = [ctypes.c_void_p]
    lib.mq_game_error.restype = ctypes.c_char_p
    lib.mq_game_snapshot.argtypes = [
        ctypes.c_void_p, _c_float_p, _c_float_p, _c_i32_p, _c_i32_p,
        _c_float_p, _c_i32_p, ctypes.c_int]
    lib.mq_game_num_statics.argtypes = [ctypes.c_void_p]
    lib.mq_game_get_statics.argtypes = [
        ctypes.c_void_p, _c_float_p, _c_float_p, _c_i32_p, _c_i32_p]
    lib.mq_game_num_models.argtypes = [ctypes.c_void_p]
    lib.mq_game_model_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mq_game_model_name.restype = ctypes.c_char_p
    lib.mq_game_num_sounds_precached.argtypes = [ctypes.c_void_p]
    lib.mq_game_sound_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mq_game_sound_name.restype = ctypes.c_char_p
    lib.mq_game_lightstyle.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mq_game_lightstyle.restype = ctypes.c_char_p
    lib.mq_game_num_prints.argtypes = [ctypes.c_void_p]
    lib.mq_game_print.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mq_game_print.restype = ctypes.c_char_p
    lib.mq_game_num_centerprints.argtypes = [ctypes.c_void_p]
    lib.mq_game_centerprint.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mq_game_centerprint.restype = ctypes.c_char_p
    lib.mq_game_num_sounds.argtypes = [ctypes.c_void_p]
    lib.mq_game_sound_sample.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mq_game_sound_sample.restype = ctypes.c_char_p
    lib.mq_game_get_sounds.argtypes = [
        ctypes.c_void_p, _c_i32_p, _c_i32_p, _c_float_p, _c_float_p,
        _c_float_p]
    lib.mq_game_changelevel.argtypes = [ctypes.c_void_p]
    lib.mq_game_changelevel.restype = ctypes.c_char_p
    lib.mq_game_num_ambient_sounds.argtypes = [ctypes.c_void_p]
    lib.mq_game_ambient_sample.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mq_game_ambient_sample.restype = ctypes.c_char_p
    lib.mq_game_get_ambient_sounds.argtypes = [
        ctypes.c_void_p, _c_float_p, _c_float_p, _c_float_p]
    lib.mq_game_num_particles.argtypes = [ctypes.c_void_p]
    lib.mq_game_get_particles.argtypes = [
        ctypes.c_void_p, _c_float_p, _c_float_p, _c_float_p, _c_float_p]
    lib.mq_game_num_edicts.argtypes = [ctypes.c_void_p]
    lib.mq_game_edict_free.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mq_game_get_field.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.mq_game_get_field.restype = ctypes.c_float
    lib.mq_game_get_field_int.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
    lib.mq_game_get_field_str.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
    lib.mq_game_get_field_str.restype = ctypes.c_char_p
    lib.mq_game_set_field.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_float]
    lib.mq_game_set_field_int.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.mq_game_get_global.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.mq_game_get_global.restype = ctypes.c_float
    lib.mq_game_execute.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.mq_game_trace.argtypes = [
        ctypes.c_void_p, _c_float_p, _c_float_p, _c_float_p, _c_float_p,
        ctypes.c_int, ctypes.c_int, _c_float_p]
    lib.mq_game_save.argtypes = [
        ctypes.c_void_p, _c_u8_p, ctypes.c_longlong]
    lib.mq_game_save.restype = ctypes.c_longlong
    lib.mq_game_restore.argtypes = [
        ctypes.c_void_p, _c_u8_p, ctypes.c_longlong]
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_c_float_p)


def _ip(a: np.ndarray):
    return a.ctypes.data_as(_c_i32_p)


@dataclass
class EntitySnapshot:
    """One frame's visible entities (≈ cl_visedicts extraction)."""

    origins: np.ndarray  # f32[N, 3]
    angles: np.ndarray  # f32[N, 3] pitch yaw roll
    modelindex: np.ndarray  # i32[N] into QuakeHost.model_names
    frames: np.ndarray  # i32[N] animation frame
    alphas: np.ndarray  # f32[N]
    edict_ids: np.ndarray  # i32[N]


@dataclass
class PlayerState:
    """Player view + HUD stats (hud.cpp:49-75 reads the same globals)."""

    origin: np.ndarray
    velocity: np.ndarray
    view_angles: np.ndarray
    view_ofs: np.ndarray
    punchangle: np.ndarray
    health: float = 100.0
    armor: float = 0.0
    items: int = 0
    waterlevel: int = 0
    watertype: int = 0
    weapon: int = 0
    currentammo: float = 0.0
    flags: int = 0


@dataclass
class WorldHulls:
    """Flat collision tables (models/bsp.py load_collision output)."""

    planes: np.ndarray  # f32[NP, 4] normal+dist
    clipnodes: np.ndarray  # i32[NC, 3] planenum, child0, child1
    headnodes: np.ndarray  # i32[NM, 3] per-model hull head nodes
    bounds: np.ndarray  # f32[NM, 6] mins+maxs

    @staticmethod
    def room(
        mins, maxs, boxes: list[tuple] | None = None
    ) -> "WorldHulls":
        """A sealed room with optional solid boxes inside (tests /
        procedural maps).

        The room interior is empty, everything outside — and inside any
        of the `boxes` [(bmins, bmaxs), ...] — is solid. Hulls 1 and 2
        get their own plane sets, Minkowski-expanded by the standard
        clip boxes — exactly what qbsp bakes into the BSP's clipnode
        hulls.
        """
        CONTENTS_EMPTY, CONTENTS_SOLID = -1, -2
        mins = np.asarray(mins, np.float32)
        maxs = np.asarray(maxs, np.float32)
        boxes = [
            (np.asarray(a, np.float32), np.asarray(b, np.float32))
            for a, b in (boxes or [])
        ]
        # standard hull clip boxes (world.cc kMins/kMaxs)
        clips = [
            ((0, 0, 0), (0, 0, 0)),
            ((-16, -16, -24), (16, 16, 32)),
            ((-32, -32, -24), (32, 32, 64)),
        ]
        planes, cn, headnodes = [], [], []

        def axis_plane(axis, dist):
            n = [0.0, 0.0, 0.0]
            n[axis] = 1.0
            planes.append(n + [float(dist)])
            return len(planes) - 1

        for cmins, cmaxs in clips:
            cmins = np.asarray(cmins, np.float32)
            cmaxs = np.asarray(cmaxs, np.float32)
            base = len(cn)
            headnodes.append(base)
            # solid-box chains first: in-box → SOLID, escape → next chain
            for k, (bmins, bmaxs) in enumerate(boxes):
                blo = bmins - cmaxs  # expanded obstacle
                bhi = bmaxs - cmins
                bbase = base + 6 * k
                escape = bbase + 6  # next box chain or the room chain
                for i in range(6):
                    axis = i // 2
                    p = axis_plane(axis, blo[axis] if i % 2 == 0 else bhi[axis])
                    inside = bbase + i + 1 if i < 5 else CONTENTS_SOLID
                    if i % 2 == 0:  # front (x > lo) possibly inside
                        cn.append([p, inside, escape])
                    else:  # front (x > hi) definitely outside
                        cn.append([p, escape, inside])
            # room shell: inside all 6 planes → EMPTY, outside → SOLID
            lo = mins - cmins  # shrunken interior
            hi = maxs - cmaxs
            rbase = len(cn)
            for i in range(6):
                axis = i // 2
                p = axis_plane(axis, lo[axis] if i % 2 == 0 else hi[axis])
                inside = rbase + i + 1 if i < 5 else CONTENTS_EMPTY
                if i % 2 == 0:  # lower bound: front (x > dist) = inside
                    cn.append([p, inside, CONTENTS_SOLID])
                else:  # upper bound: behind (x < dist) = inside
                    cn.append([p, CONTENTS_SOLID, inside])
        bounds = np.concatenate([mins, maxs])[None].astype(np.float32)
        return WorldHulls(
            np.array(planes, np.float32),
            np.array(cn, np.int32),
            np.array([headnodes], np.int32),
            bounds,
        )

    @staticmethod
    def box_room(half: float = 256.0, height: float = 256.0) -> "WorldHulls":
        return WorldHulls.room(
            (-half, -half, 0.0), (half, half, height)
        )


class QuakeHost:
    """The live game: QuakeC VM + BSP collision + server physics.

    Replaces SURVEY.md §2.5's quakespasm host loop: ``spawn`` ≈
    Host_Init (+SV_SpawnServer), ``frame`` ≈ Host_Frame, ``snapshot``/
    ``player_state`` ≈ the extraction QuakeNode::process performs.
    """

    def __init__(self, max_edicts: int = 4096):
        self._lib = _load()
        self._h = ctypes.c_void_p(self._lib.mq_game_create())
        self.max_edicts = max_edicts
        self._progs_loaded = False

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.mq_game_destroy(self._h)
        except Exception:
            pass

    def _check(self, ok: int, what: str):
        if not ok:
            raise RuntimeError(
                f"{what}: {self._lib.mq_game_error(self._h).decode()}"
            )

    # ---- setup ----
    def load_progs(self, progs_bytes: bytes):
        buf = (ctypes.c_uint8 * len(progs_bytes)).from_buffer_copy(progs_bytes)
        self._check(
            self._lib.mq_game_load_progs(
                self._h, buf, len(progs_bytes), self.max_edicts
            ),
            "load_progs",
        )
        self._progs_loaded = True

    def load_world(self, hulls: WorldHulls):
        planes = np.ascontiguousarray(hulls.planes, np.float32)
        clipnodes = np.ascontiguousarray(hulls.clipnodes, np.int32)
        headnodes = np.ascontiguousarray(hulls.headnodes, np.int32)
        bounds = np.ascontiguousarray(hulls.bounds, np.float32)
        self._lib.mq_game_load_world(
            self._h, _fp(planes), len(planes), _ip(clipnodes), len(clipnodes),
            _ip(headnodes), _fp(bounds), len(headnodes),
        )

    def set_model_bounds(self, name: str, mins, maxs):
        mn = np.ascontiguousarray(mins, np.float32)
        mx = np.ascontiguousarray(maxs, np.float32)
        self._lib.mq_game_set_model_bounds(
            self._h, name.encode(), _fp(mn), _fp(mx)
        )

    def set_cvar(self, name: str, value: float):
        self._lib.mq_game_set_cvar(self._h, name.encode(), float(value))

    def cvar(self, name: str) -> float:
        return float(self._lib.mq_game_cvar(self._h, name.encode()))

    def spawn(self, entity_lump: str, mapname: str = "maps/map.bsp",
              client: bool = True):
        self._check(
            self._lib.mq_game_spawn_server(
                self._h, entity_lump.encode(), mapname.encode()
            ),
            "spawn_server",
        )
        if client:
            self._check(self._lib.mq_game_spawn_client(self._h),
                        "spawn_client")

    # ---- stepping ----
    def set_usercmd(self, forward=0.0, side=0.0, up=0.0, pitch=0.0, yaw=0.0,
                    roll=0.0, attack=False, jump=False, use=False, impulse=0):
        buttons = (1 if attack else 0) | (2 if use else 0) | (4 if jump else 0)
        self._lib.mq_game_set_usercmd(
            self._h, float(forward), float(side), float(up), float(pitch),
            float(yaw), float(roll), buttons, int(impulse),
        )

    def frame(self, dt: float = 1.0 / 60.0):
        self._check(self._lib.mq_game_frame(self._h, float(dt)), "frame")

    @property
    def time(self) -> float:
        return float(self._lib.mq_game_time(self._h))

    @property
    def player(self) -> int:
        """Player edict index (≈ sv_player)."""
        return int(self._lib.mq_game_player(self._h))

    def trace(self, start, end, mins=(0, 0, 0), maxs=(0, 0, 0),
              type: int = 0, passedict: int = -1):
        """Box trace through world + entities (SV_Move equivalent).

        Returns (fraction, endpos f32[3], plane_normal f32[3], ent).
        """
        s = np.ascontiguousarray(start, np.float32)
        e = np.ascontiguousarray(end, np.float32)
        mn = np.ascontiguousarray(mins, np.float32)
        mx = np.ascontiguousarray(maxs, np.float32)
        out = np.zeros((10,), np.float32)
        self._lib.mq_game_trace(
            self._h, _fp(s), _fp(mn), _fp(mx), _fp(e), int(type),
            int(passedict), _fp(out),
        )
        return float(out[0]), out[1:4].copy(), out[4:7].copy(), int(out[9])

    # ---- extraction ----
    def snapshot(self, max_out: int = 1024) -> EntitySnapshot:
        origins = np.zeros((max_out, 3), np.float32)
        angles = np.zeros((max_out, 3), np.float32)
        modelindex = np.zeros((max_out,), np.int32)
        frames = np.zeros((max_out,), np.int32)
        alphas = np.zeros((max_out,), np.float32)
        eids = np.zeros((max_out,), np.int32)
        n = self._lib.mq_game_snapshot(
            self._h, _fp(origins), _fp(angles), _ip(modelindex), _ip(frames),
            _fp(alphas), _ip(eids), max_out,
        )
        return EntitySnapshot(
            origins=origins[:n], angles=angles[:n], modelindex=modelindex[:n],
            frames=frames[:n], alphas=alphas[:n], edict_ids=eids[:n],
        )

    def statics(self) -> EntitySnapshot:
        n = self._lib.mq_game_num_statics(self._h)
        origins = np.zeros((n, 3), np.float32)
        angles = np.zeros((n, 3), np.float32)
        modelindex = np.zeros((n,), np.int32)
        frames = np.zeros((n,), np.int32)
        self._lib.mq_game_get_statics(
            self._h, _fp(origins), _fp(angles), _ip(modelindex), _ip(frames)
        )
        return EntitySnapshot(
            origins=origins, angles=angles, modelindex=modelindex,
            frames=frames, alphas=np.ones((n,), np.float32),
            edict_ids=np.full((n,), -1, np.int32),
        )

    @property
    def model_names(self) -> list[str]:
        n = self._lib.mq_game_num_models(self._h)
        return [
            self._lib.mq_game_model_name(self._h, i).decode()
            for i in range(n)
        ]

    @property
    def sound_names(self) -> list[str]:
        n = self._lib.mq_game_num_sounds_precached(self._h)
        return [
            self._lib.mq_game_sound_name(self._h, i).decode()
            for i in range(n)
        ]

    def lightstyle(self, i: int) -> str:
        return self._lib.mq_game_lightstyle(self._h, i).decode()

    def prints(self) -> list[str]:
        n = self._lib.mq_game_num_prints(self._h)
        return [self._lib.mq_game_print(self._h, i).decode()
                for i in range(n)]

    def centerprints(self) -> list[str]:
        n = self._lib.mq_game_num_centerprints(self._h)
        return [
            self._lib.mq_game_centerprint(self._h, i).decode()
            for i in range(n)
        ]

    def frame_sounds(self) -> list[str]:
        n = self._lib.mq_game_num_sounds(self._h)
        return [
            self._lib.mq_game_sound_sample(self._h, i).decode()
            for i in range(n)
        ]

    def frame_sound_events(self):
        """Full per-frame sound events for the audio mixer: list of
        (ent, channel, sample, volume, attenuation, origin[3])."""
        n = self._lib.mq_game_num_sounds(self._h)
        if n == 0:
            return []
        names = [
            self._lib.mq_game_sound_sample(self._h, i).decode()
            for i in range(n)
        ]
        ent = np.zeros((n,), np.int32)
        chan = np.zeros((n,), np.int32)
        org = np.zeros((n, 3), np.float32)
        vol = np.zeros((n,), np.float32)
        att = np.zeros((n,), np.float32)
        self._lib.mq_game_get_sounds(
            self._h, _ip(ent), _ip(chan), _fp(org), _fp(vol), _fp(att)
        )
        return [
            (int(ent[i]), int(chan[i]), names[i], float(vol[i]),
             float(att[i]), org[i].copy())
            for i in range(n)
        ]

    @property
    def changelevel_target(self) -> str:
        """Map requested by the QC changelevel() builtin ('' = none)."""
        return self._lib.mq_game_changelevel(self._h).decode()

    def ambient_sounds(self):
        """Static looping ambients committed by QC ambientsound():
        list of (sample, volume, attenuation, origin[3])."""
        n = self._lib.mq_game_num_ambient_sounds(self._h)
        if n == 0:
            return []
        names = [
            self._lib.mq_game_ambient_sample(self._h, i).decode()
            for i in range(n)
        ]
        org = np.zeros((n, 3), np.float32)
        vol = np.zeros((n,), np.float32)
        att = np.zeros((n,), np.float32)
        self._lib.mq_game_get_ambient_sounds(
            self._h, _fp(org), _fp(vol), _fp(att)
        )
        return [
            (names[i], float(vol[i]), float(att[i]), org[i].copy())
            for i in range(n)
        ]

    def frame_particles(self):
        n = self._lib.mq_game_num_particles(self._h)
        org = np.zeros((n, 3), np.float32)
        dr = np.zeros((n, 3), np.float32)
        color = np.zeros((n,), np.float32)
        count = np.zeros((n,), np.float32)
        if n:
            self._lib.mq_game_get_particles(
                self._h, _fp(org), _fp(dr), _fp(color), _fp(count)
            )
        return org, dr, color, count

    # field / global access
    def get_field(self, ent: int, name: str, vector: bool = False):
        if vector:
            return np.array(
                [
                    self._lib.mq_game_get_field(self._h, ent, name.encode(), c)
                    for c in range(3)
                ],
                np.float32,
            )
        return float(self._lib.mq_game_get_field(self._h, ent, name.encode(), 0))

    def get_field_int(self, ent: int, name: str) -> int:
        """Entity/function/int field value (e.g. enemy, goalentity)."""
        return int(self._lib.mq_game_get_field_int(self._h, ent, name.encode()))

    def get_field_str(self, ent: int, name: str) -> str:
        return self._lib.mq_game_get_field_str(
            self._h, ent, name.encode()
        ).decode()

    def set_field(self, ent: int, name: str, value, vector: bool = False):
        if vector:
            for c in range(3):
                self._lib.mq_game_set_field(
                    self._h, ent, name.encode(), c, float(value[c])
                )
        else:
            self._lib.mq_game_set_field(
                self._h, ent, name.encode(), 0, float(value)
            )

    def get_global(self, name: str, vector: bool = False):
        if vector:
            return np.array(
                [
                    self._lib.mq_game_get_global(self._h, name.encode(), c)
                    for c in range(3)
                ],
                np.float32,
            )
        return float(self._lib.mq_game_get_global(self._h, name.encode(), 0))

    def execute(self, fn_name: str, self_ent: int = 0):
        self._check(
            self._lib.mq_game_execute(self._h, fn_name.encode(), self_ent),
            f"execute {fn_name}",
        )

    def save_state(self) -> bytes:
        """Checkpoint the full dynamic game state (SURVEY.md §5: the
        reference's Quake savegame seam). Restore onto a host with the
        same progs + world loaded."""
        size = self._lib.mq_game_save(self._h, None, 0)
        buf = np.zeros(int(size), np.uint8)
        got = self._lib.mq_game_save(
            self._h, buf.ctypes.data_as(_c_u8_p), size
        )
        assert got == size
        return buf.tobytes()

    def restore_state(self, blob: bytes):
        buf = np.frombuffer(bytearray(blob), np.uint8)
        self._check(
            self._lib.mq_game_restore(
                self._h, buf.ctypes.data_as(_c_u8_p), len(blob)
            ),
            "restore_state",
        )

    def save(self, path: str):
        """Write a savegame file (≈ Host_Savegame_f)."""
        with open(path, "wb") as f:
            f.write(self.save_state())

    def load(self, path: str):
        """Load a savegame file (≈ Host_Loadgame_f)."""
        with open(path, "rb") as f:
            self.restore_state(f.read())

    def player_state(self) -> PlayerState:
        p = self._lib.mq_game_player(self._h)
        g = self.get_field
        return PlayerState(
            origin=g(p, "origin", vector=True),
            velocity=g(p, "velocity", vector=True),
            view_angles=g(p, "v_angle", vector=True),
            view_ofs=g(p, "view_ofs", vector=True),
            punchangle=g(p, "punchangle", vector=True),
            health=g(p, "health"),
            armor=g(p, "armorvalue"),
            items=int(g(p, "items")),
            waterlevel=int(g(p, "waterlevel")),
            watertype=int(g(p, "watertype")),
            weapon=int(g(p, "weapon")),
            currentammo=g(p, "currentammo"),
            flags=int(g(p, "flags")),
        )
