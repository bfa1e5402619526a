"""Live game → renderer bridge (the reference's QuakeNode seam, whole).

The reference's QuakeNode embeds quakespasm and, per frame, rendezvous
with the game thread, then extracts camera/fog uniforms and rebuilds
dynamic entity geometry (quake_node.cpp:713-824). ``LiveGame`` is the
same contract on top of our native host (native/game/): step the
simulation, pull the entity snapshot, rebuild the dynamic scene through
``GameState``, and derive the camera from the player's view state
(origin + view_ofs, v_angle + punchangle — matching the reference's
uniform fill at quake_node.cpp:768-824).

Client-side particles mirror quakespasm's CL_RunParticleEffect /
CL_RunParticles: QC ``particle(org, dir, color, count)`` builtin calls
surface as per-frame events; we spawn short-lived gravity-affected
particles from them and hand the live set to the geometry extractor
(game/particles.py turns them into emissive tetrahedra exactly like
quake_helpers.cpp:50-216).

Copy of merian_quake_tpu/game/live.py for the PyTorch port: ``LiveGame``
takes ``device=`` for its ``GameState`` (the card unless the caller asks
for the CPU), and ``draw_overlays`` takes the port's LDR tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .host import QuakeHost
from .hud import HudState
from .state import Entity, GameState

# Quake point contents (bspfile.h values, used by watertype)
CONTENTS_WATER, CONTENTS_SLIME, CONTENTS_LAVA = -3, -4, -5

# server frame → pose blend window (quakespasm r_lerpmodels: 0.1 s)
LERP_TIME = 0.1


def angle_vectors(angles) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quake AngleVectors: (pitch, yaw, roll) degrees → fwd/right/up."""
    p, y, r = (math.radians(float(a)) for a in angles)
    sp, cp = math.sin(p), math.cos(p)
    sy, cy = math.sin(y), math.cos(y)
    sr, cr = math.sin(r), math.cos(r)
    fwd = np.asarray([cp * cy, cp * sy, -sp], np.float32)
    right = np.asarray(
        [-sr * sp * cy + cr * sy, -sr * sp * sy - cr * cy, -sr * cp],
        np.float32,
    )
    up = np.asarray(
        [cr * sp * cy + sr * sy, cr * sp * sy - sr * cy, cr * cp],
        np.float32,
    )
    return fwd, right, up


class ClientParticles:
    """Short-lived particle pool fed by QC particle() events.

    R_RunParticleEffect semantics: `count` particles at org±8, velocity
    dir*15, color (base & ~7) + rand(8), die in 0.1-0.5 s under reduced
    gravity (quakespasm pt_slowgrav).
    """

    def __init__(self, capacity: int = 4096, reproducible: bool = True):
        self.capacity = capacity
        self.pos = np.zeros((0, 3), np.float32)
        self.vel = np.zeros((0, 3), np.float32)
        self.color = np.zeros((0,), np.uint8)
        self.die = np.zeros((0,), np.float32)
        self._rng = np.random.default_rng(1337 if reproducible else None)

    def spawn_effect(self, org, direction, color, count, now: float):
        n = int(count)
        if n <= 0:
            return
        pos = np.asarray(org, np.float32) + self._rng.uniform(
            -8.0, 8.0, (n, 3)
        ).astype(np.float32)
        vel = np.tile(np.asarray(direction, np.float32) * 15.0, (n, 1))
        col = (int(color) & ~7) + self._rng.integers(0, 8, n)
        die = now + 0.1 * self._rng.integers(1, 6, n).astype(np.float32)
        self.pos = np.concatenate([self.pos, pos])[-self.capacity:]
        self.vel = np.concatenate([self.vel, vel])[-self.capacity:]
        self.color = np.concatenate(
            [self.color, col.astype(np.uint8)]
        )[-self.capacity:]
        self.die = np.concatenate([self.die, die])[-self.capacity:]

    def step(self, now: float, dt: float, gravity: float = 800.0):
        alive = self.die > now
        self.pos = self.pos[alive] + self.vel[alive] * dt
        self.vel = self.vel[alive].copy()
        self.vel[:, 2] -= 0.05 * gravity * dt  # pt_slowgrav
        self.color = self.color[alive]
        self.die = self.die[alive]

    def arrays(self):
        if len(self.pos) == 0:
            return None
        return self.pos, self.color


@dataclass
class _Template:
    model: object
    texnum: int
    fb_texnum: int = 0
    is_sprite: bool = False
    frame_rate: float = 10.0


class LiveGame:
    """Owns a QuakeHost + GameState; one ``step()`` = one game+render
    frame's scene extraction.

    `models` maps the game's model names (as precached by QC, e.g.
    "progs/ball.mdl") to loaded AliasModel / SpriteModel objects. Edicts
    whose model has no entry are skipped (the reference likewise skips
    models it can't build geometry for).
    """

    def __init__(
        self,
        host: QuakeHost,
        bundle,
        models: dict | None = None,
        dynamic_capacity: int = 2048,
        reproducible: bool = True,
        device="cuda",
    ):
        from ..models.mdl import AliasModel

        self.host = host
        self.gs = GameState(bundle, dynamic_capacity=dynamic_capacity, device=device)
        self.gs.reproducible = reproducible
        self._extract_dynamic_only = False
        self.particles = ClientParticles(reproducible=reproducible)
        self.templates: dict[str, _Template] = {}
        for name, mdl in (models or {}).items():
            if isinstance(mdl, AliasModel):
                ent = self.gs.add_alias_entity(mdl)
                self.templates[name] = _Template(
                    mdl, ent.texnum, ent.fb_texnum
                )
            else:  # sprite
                self.gs.add_sprite_entity(mdl, (0.0, 0.0, 0.0))
                self.templates[name] = _Template(
                    mdl, self.gs.sprites[-1][2], is_sprite=True
                )
        self.gs.rebuild_atlas()
        # registration entities/sprites were only for atlas packing;
        # resolve the fixed-up texnums back into the templates
        for tpl, ent in zip(
            (t for t in self.templates.values() if not t.is_sprite),
            self.gs.entities,
        ):
            tpl.texnum, tpl.fb_texnum = ent.texnum, ent.fb_texnum
        for tpl, spr in zip(
            (t for t in self.templates.values() if t.is_sprite),
            self.gs.sprites,
        ):
            tpl.texnum = spr[2]
        self.gs.entities = []
        self.gs.sprites = []
        self._static_entities: list[Entity] = []
        self._static_sprites: list[list] = []
        self._statics_built = False
        # per-edict animation state: eid -> [prev_frame, frame, t_change]
        self._anim: dict[int, list] = {}
        self._cam = None  # (pos, fwd, up)
        self._cam_prev = None
        self.view_angles = np.zeros(3, np.float32)  # caller-steered
        # message overlay state (centerprint hold + console print log)
        self._center_msg = ""
        self._center_expire = 0.0
        self._print_log: list[tuple[str, float]] = []

    # ---- per-frame ----
    def _build_statics(self):
        """Static entities (QC makestatic torches etc.) — extracted once
        after spawn, like the reference's cl_static_entities walk."""
        names = self.host.model_names
        snap = self.host.statics()
        for i in range(len(snap.origins)):
            mi = int(snap.modelindex[i])
            name = names[mi] if 0 <= mi < len(names) else ""
            tpl = self.templates.get(name)
            if tpl is None:
                continue
            if tpl.is_sprite:
                self._static_sprites.append(
                    [tpl.model, snap.origins[i].copy(), tpl.texnum,
                     tpl.frame_rate]
                )
                continue
            f = int(snap.frames[i])
            self._static_entities.append(
                Entity(
                    model=tpl.model,
                    texnum=tpl.texnum,
                    fb_texnum=tpl.fb_texnum,
                    origin=snap.origins[i].copy(),
                    angles=snap.angles[i].copy(),
                    frame_override=(f, f, 0.0),
                )
            )
        self._statics_built = True

    def step(
        self,
        dt: float = 1.0 / 60.0,
        forward: float = 0.0,
        side: float = 0.0,
        up: float = 0.0,
        yaw: float | None = None,
        pitch: float | None = None,
        attack: bool = False,
        jump: bool = False,
        impulse: int = 0,
    ):
        """Advance the game one tick and extract Scene + Uniforms."""
        if yaw is not None:
            self.view_angles[1] = yaw
        if pitch is not None:
            self.view_angles[0] = pitch
        self.host.set_usercmd(
            forward=forward, side=side, up=up,
            pitch=float(self.view_angles[0]),
            yaw=float(self.view_angles[1]),
            roll=float(self.view_angles[2]),
            attack=attack, jump=jump, impulse=impulse,
        )
        self.host.frame(dt)
        t = self.host.time
        self._update_overlays(t)
        if not self._statics_built:
            self._build_statics()

        # client particles from this frame's QC particle() events
        org, dirs, color, count = self.host.frame_particles()
        for i in range(len(org)):
            self.particles.spawn_effect(org[i], dirs[i], color[i], count[i], t)
        self.particles.step(t, dt)
        pa = self.particles.arrays()
        self.gs.particles = pa if pa is not None else None

        # live entities
        names = self.host.model_names
        snap = self.host.snapshot(max_out=self.gs.dynamic_capacity)
        player = self.host.player
        ents = list(self._static_entities)
        sprites = list(self._static_sprites)
        for i in range(len(snap.origins)):
            eid = int(snap.edict_ids[i])
            if eid == player:  # first person: don't draw yourself
                continue
            mi = int(snap.modelindex[i])
            name = names[mi] if 0 <= mi < len(names) else ""
            tpl = self.templates.get(name)
            if tpl is None:
                continue
            if tpl.is_sprite:
                sprites.append(
                    [tpl.model, snap.origins[i].copy(), tpl.texnum,
                     tpl.frame_rate]
                )
                continue
            f = int(snap.frames[i])
            st = self._anim.setdefault(eid, [f, f, t])
            if f != st[1]:
                st[0], st[1], st[2] = st[1], f, t
            blend = min((t - st[2]) / LERP_TIME, 1.0)
            ents.append(
                Entity(
                    model=tpl.model,
                    texnum=tpl.texnum,
                    fb_texnum=tpl.fb_texnum,
                    origin=snap.origins[i].copy(),
                    angles=snap.angles[i].copy(),
                    frame_override=(st[0], st[1], blend),
                )
            )
        self.gs.entities = ents
        self.gs.sprites = sprites

        # camera from the player's view state (quake_node.cpp:768-790)
        ps = self.host.player_state()
        pos = ps.origin + ps.view_ofs
        fwd, _right, upv = angle_vectors(ps.view_angles + ps.punchangle)
        self._cam_prev = self._cam if self._cam is not None else (pos, fwd, upv)
        self._cam = (pos, fwd, upv)
        prev_t = self.gs.time
        cams = {round(t, 6): self._cam, round(prev_t, 6): self._cam_prev}
        self.gs.camera_path = lambda tt: cams.get(round(tt, 6), self._cam)

        self.gs.prev_time = prev_t
        self.gs.time = t
        self.gs.frame += 1
        if self._extract_dynamic_only:
            return self.gs.extract_dynamic()
        return self.gs.extract()

    def step_dynamic(self, **kw):
        """step(), but extract only the dynamic block (+ uniforms) for
        the incremental accel path (accel/build.py refresh_dynamic) —
        the static soup is built once, per-frame work is O(dynamic)."""
        self._extract_dynamic_only = True
        try:
            return self.step(**kw)
        finally:
            self._extract_dynamic_only = False

    def hud_state(self) -> HudState:
        """HUD push constants from game globals (hud.cpp:49-75)."""
        ps = self.host.player_state()
        liquid = 0
        if ps.waterlevel >= 3:
            liquid = {
                CONTENTS_WATER: 1, CONTENTS_LAVA: 2, CONTENTS_SLIME: 3,
            }.get(ps.watertype, 0)
        p = self.host.player
        dmg = self.host.get_field(p, "dmg_take") + self.host.get_field(
            p, "dmg_save"
        )
        blend = (0.0, 0.0, 0.0, 0.0)
        if dmg > 0:
            blend = (1.0, 0.2, 0.1, min(dmg, 20.0) / 20.0 * 0.5)
        return HudState(
            health=ps.health,
            armor=ps.armor,
            screen_blend=blend,
            liquid=liquid,
        )

    @property
    def messages(self) -> list[str]:
        """This frame's console prints + centerprints (overlay text,
        merian-quake.cpp:220-267)."""
        return self.host.prints() + self.host.centerprints()

    # ---- on-screen message overlays (QuakeMessageOverlay,
    # merian-quake.cpp:55-131: centerprint centered in the upper third
    # with a hold time, console prints as a fading top-left log) ----
    CENTER_HOLD = 2.0  # scr_centertime default
    PRINT_HOLD = 4.0
    PRINT_LINES = 4

    def _update_overlays(self, t: float):
        for msg in self.host.centerprints():
            self._center_msg = msg
            self._center_expire = t + self.CENTER_HOLD
        for msg in self.host.prints():
            self._print_log.append((msg.rstrip("\n"), t + self.PRINT_HOLD))
        self._print_log = self._print_log[-self.PRINT_LINES :]

    def overlay_texts(self) -> list[tuple[str, str]]:
        """Active overlay texts as (kind, text): kind 'center'|'print'."""
        t = self.host.time
        out = []
        if getattr(self, "_center_msg", "") and t < self._center_expire:
            out.append(("center", self._center_msg))
        for msg, exp in getattr(self, "_print_log", []):
            if t < exp:
                out.append(("print", msg))
        return out

    def draw_overlays(self, img):
        """Composite active centerprint/console text onto a frame, the
        port's LDR tensor f32[H, W, 3] or a numpy array (host-side, after
        the frame — the reference's ImGui overlay pass); returns numpy."""
        import torch

        from .font import GLYPH_H, draw_text

        if isinstance(img, torch.Tensor):
            img = img.detach().cpu().numpy()
        img = np.asarray(img)
        H = img.shape[0]
        scale = max(H // 240, 1)
        y_log = 4
        for kind, text in self.overlay_texts():
            if kind == "center":
                img = draw_text(
                    img, text, cx=None, y=H // 3, scale=scale,
                    color=(1.0, 0.85, 0.5),
                )
            else:
                img = draw_text(
                    img, text, cx=4, y=y_log, scale=scale,
                    color=(1.0, 1.0, 1.0),
                )
                y_log += (GLYPH_H + 1) * scale
        return img
