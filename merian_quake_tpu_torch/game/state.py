"""Frame-indexed game state: static map + dynamic entities + camera.

Mirrors the QuakeNode update cycle (quake_node.cpp:713-824): per frame,
static brush geometry stays fixed, dynamic entity geometry is rebuilt
(with the previous frame's positions kept for motion vectors), and the
camera/fog/sun uniforms are refreshed. Scene arrays keep STATIC shapes
across frames (static triangles + a fixed dynamic capacity) so the
jitted renderer never recompiles.

Copy of merian_quake_tpu/game/state.py for the PyTorch port: the host
work is the same numpy; ``extract``/``extract_dynamic`` and the
uniforms place their tensors on the state's ``device`` (the card unless
the caller asks for the CPU). The static scene and the camera of the
bundle are read back to the host once, when the state is made (and the
atlas once more in ``rebuild_atlas``, at worldspawn), never per frame.

Reproducibility controls mirror the reference (quake_node.hpp:256,
quake_node.cpp:832-837): fixed seeds, `freeze_time` (≈ 'stop after
worldspawn') and deterministic entity animation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .particles import particles_to_soup, sprite_quad

from ..models import materials
from ..models.atlas import pack_textures
from ..models.mdl import AliasModel
from ..models import palette as pal_mod
from ..models.procedural import SceneBundle
from ..models.types import CLUSTER_SIZE, Scene, Uniforms, build_scene_from_soup, host_to_device


@dataclass
class Entity:
    """A placed, animated alias model (≈ entity_t + R_SetupAliasFrame)."""

    model: AliasModel
    texnum: int  # atlas id of the skin
    fb_texnum: int = 0
    origin: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    angles: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    frame_rate: float = 10.0
    # optional movement: origin_fn(time) -> origin
    origin_fn: Callable | None = None
    yaw_fn: Callable | None = None
    # live-game override: (f0, f1, blend) from the server's .frame field
    # instead of free-running time (game/live.py sets this per frame)
    frame_override: tuple | None = None

    def pose(self, time: float):
        """Keyframe pair + blend (R_SetupAliasFrame semantics)."""
        nf = self.model.frames.shape[0]
        if self.frame_override is not None:
            f0, f1, blend = self.frame_override
            return min(int(f0), nf - 1), min(int(f1), nf - 1), float(blend)
        if nf <= 1:
            return 0, 0, 0.0
        x = time * self.frame_rate
        f0 = int(math.floor(x)) % nf
        f1 = (f0 + 1) % nf
        return f0, f1, x - math.floor(x)

    def transform(self, time: float):
        origin = (
            np.asarray(self.origin_fn(time), np.float32)
            if self.origin_fn
            else self.origin
        )
        if self.yaw_fn is not None:
            pitch, yaw, roll = 0.0, float(self.yaw_fn(time)), 0.0
        else:
            pitch, yaw, roll = (float(a) for a in self.angles)
        # quakespasm R_RotateForEntity order: Rz(yaw) Ry(-pitch) Rx(roll)
        cy, sy = math.cos(math.radians(yaw)), math.sin(math.radians(yaw))
        cp, sp = math.cos(math.radians(-pitch)), math.sin(math.radians(-pitch))
        cr, sr = math.cos(math.radians(roll)), math.sin(math.radians(roll))
        rz = np.asarray([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float32)
        if pitch == 0.0 and roll == 0.0:
            return origin, rz
        ry = np.asarray([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]], np.float32)
        rx = np.asarray([[1, 0, 0], [0, cr, -sr], [0, sr, cr]], np.float32)
        return origin, (rz @ ry @ rx).astype(np.float32)

    def world_verts(self, time: float) -> np.ndarray:
        f0, f1, blend = self.pose(time)
        v = self.model.frames[f0] * (1 - blend) + self.model.frames[f1] * blend
        origin, rot = self.transform(time)
        return v @ rot.T + origin


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class GameState:
    """Holds the loaded map, entities and camera; steps per frame."""

    def __init__(
        self,
        bundle: SceneBundle,
        dynamic_capacity: int = 2048,
        freeze_time: bool = False,
        device="cuda",
    ):
        self.device = torch.device(device)
        torch.empty(0, device=self.device)  # no such device: raise here, not mid-game
        self.static_bundle = bundle
        # the static soup and the bundle's camera on the host, read once
        self._static_host = Scene(*[_np(a) for a in bundle.scene])
        self._base_cam = tuple(
            _np(getattr(bundle.uniforms, k)) for k in ("cam_x", "cam_w", "cam_u")
        )
        self.entities: list[Entity] = []
        self.dynamic_capacity = dynamic_capacity
        self.freeze_time = freeze_time
        self.time = 0.0
        self.prev_time = 0.0
        self.frame = 0
        self.camera_path: Callable | None = None  # t -> (pos, fwd, up)
        self._extra_textures: list[np.ndarray] = []
        self._prev_dynamic: np.ndarray | None = None
        self.sprites: list = []  # (SpriteModel, origin, texnum, frame_rate)
        # particles: (origins f32[P,3], palette color indices u8[P])
        self.particles: tuple | None = None
        self.reproducible: bool = True

    # ---- content ----
    def add_alias_entity(self, model: AliasModel, palette=None, **kw) -> Entity:
        palette = palette if palette is not None else pal_mod.default_palette()
        rgba = pal_mod.indexed_to_rgba(model.skins[0], palette)
        self._extra_textures.append(rgba)
        fb = pal_mod.fullbright_mask(model.skins[0])
        fbnum = 0
        if fb.any():
            em = rgba.copy()
            em[~fb, :3] = 0
            self._extra_textures.append(em)
            fbnum = -len(self._extra_textures)  # resolved in rebuild_atlas
        ent = Entity(model=model, texnum=-(len(self._extra_textures) - (1 if fbnum else 0)), fb_texnum=fbnum, **kw)
        self.entities.append(ent)
        return ent

    def add_sprite_entity(self, sprite, origin, palette=None, frame_rate=10.0):
        """Register a sprite (billboard rebuilt per frame facing the
        camera; always emissive, add_geo_sprite semantics)."""
        palette = palette if palette is not None else pal_mod.default_palette()
        rgba = pal_mod.indexed_to_rgba(
            sprite.frames[0].pixels, palette, fence=True
        )
        self._extra_textures.append(rgba)
        texnum = -len(self._extra_textures)
        self.sprites.append(
            [sprite, np.asarray(origin, np.float32), texnum, frame_rate]
        )

    def set_particles(self, origins, color_indices):
        self.particles = (
            np.asarray(origins, np.float32),
            np.asarray(color_indices, np.uint8),
        )

    def rebuild_atlas(self):
        """Repack the atlas with entity skins appended (worldspawn-time
        operation, like the reference's texture upload queue)."""
        base = self.static_bundle.atlas
        base_tex = _np(base.data).astype(np.float32)
        # re-pack: take original table entries as images
        imgs = []
        table = _np(base.table)
        for x, y, w, h in table:
            if w == 0:
                break
            img = base_tex[y : y + h, x : x + w]
            imgs.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
        n_base = len(imgs)
        imgs.extend(self._extra_textures)
        # entity texnums were negative placeholders; fix them
        for ent in self.entities:
            if ent.texnum < 0:
                ent.texnum = n_base - ent.texnum - 1
            if ent.fb_texnum < 0:
                ent.fb_texnum = n_base - ent.fb_texnum - 1
        for spr in self.sprites:
            if spr[2] < 0:
                spr[2] = n_base - spr[2] - 1
        atlas = pack_textures(imgs, srgb=[False] * len(imgs), device=self.device)
        self.static_bundle = self.static_bundle._replace(atlas=atlas)

    # ---- stepping ----
    def step(self, dt: float = 1.0 / 60.0):
        """Advance simulation (≈ Host_Frame + scene extraction)."""
        self.prev_time = self.time
        if not self.freeze_time:
            self.time += dt
        self.frame += 1
        return self.extract()

    def extract_dynamic(self) -> tuple[dict, "Uniforms"]:
        """This frame's DYNAMIC block only (+ uniforms): the input of
        the incremental accel refresh (accel/build.py
        refresh_dynamic) — the static soup is never re-touched, like
        the reference's per-frame BLAS refit path
        (quake_node.cpp:896-1012)."""
        return self._dyn_block(), self._uniforms()

    def extract(self) -> tuple[Scene, Uniforms]:
        """Build this frame's Scene + Uniforms (static shapes)."""
        static = self._static_host
        cap = self.dynamic_capacity
        d = self._dyn_block()

        # assemble: static soup + dynamic block, padded to cluster size
        sv = np.asarray
        n_static = static.num_tris
        total = n_static + cap
        total_pad = -(-total // CLUSTER_SIZE) * CLUSTER_SIZE
        scene = build_scene_from_soup(
            np.concatenate([sv(static.v0), d["v"][:, 0]]),
            np.concatenate([sv(static.v1), d["v"][:, 1]]),
            np.concatenate([sv(static.v2), d["v"][:, 2]]),
            st=np.concatenate([sv(static.st), d["uv"]]),
            texnum=np.concatenate([sv(static.texnum), d["tex"]]),
            fb_texnum=np.concatenate([sv(static.fb_texnum), d["fb"]]),
            flags=np.concatenate([sv(static.flags), d["flags"]]),
            alpha=np.concatenate(
                [sv(static.alpha), np.full((cap,), -1.0, np.float32)]
            ),
            solid_albedo=np.concatenate([sv(static.solid_albedo), d["salb"]]),
            solid_emission=np.concatenate(
                [sv(static.solid_emission), d["semm"]]
            ),
            pv0=np.concatenate([sv(static.pv0), d["prev"][:, 0]]),
            pv1=np.concatenate([sv(static.pv1), d["prev"][:, 1]]),
            pv2=np.concatenate([sv(static.pv2), d["prev"][:, 2]]),
            pad_to=total_pad,
            device=self.device,
        )
        # mark unused dynamic slots invalid
        valid = np.zeros((total_pad,), bool)
        valid[:n_static] = True
        valid[n_static : n_static + cap] = d["valid"]
        scene = scene._replace(valid=host_to_device(valid, self.device))
        return scene, self._uniforms()

    def _dyn_block(self) -> dict:
        cap = self.dynamic_capacity

        dyn_v = np.zeros((cap, 3, 3), np.float32)  # [tri, corner, xyz]
        dyn_prev = np.zeros((cap, 3, 3), np.float32)
        dyn_uv = np.zeros((cap, 3, 2), np.float32)
        dyn_tex = np.zeros((cap,), np.int32)
        dyn_fb = np.zeros((cap,), np.int32)
        dyn_flags = np.zeros((cap,), np.int32)
        dyn_salb = np.zeros((cap, 3), np.float32)
        dyn_semm = np.zeros((cap, 3), np.float32)
        dyn_valid = np.zeros((cap,), bool)
        cursor = 0
        for ent in self.entities:
            wv = ent.world_verts(self.time)
            pv = ent.world_verts(self.prev_time)
            tris = ent.model.tris
            n = len(tris)
            if cursor + n > cap:
                n = cap - cursor
            if n <= 0:
                break
            sel = tris[:n]
            dyn_v[cursor : cursor + n] = wv[sel]
            dyn_prev[cursor : cursor + n] = pv[sel]
            dyn_uv[cursor : cursor + n] = ent.model.uv[:n]
            dyn_tex[cursor : cursor + n] = ent.texnum
            dyn_fb[cursor : cursor + n] = ent.fb_texnum
            dyn_valid[cursor : cursor + n] = True
            cursor += n

        # sprites (camera-dependent billboards, quake_helpers.cpp:471-626)
        cam_now = (
            np.asarray(self.camera_path(self.time)[0], np.float32)
            if self.camera_path is not None
            else self._base_cam[0]
        )
        for sprite, origin, texnum, frame_rate in self.sprites:
            fi = int(self.time * frame_rate)
            sv0, sv1, sv2, suv = sprite_quad(sprite, fi, origin, cam_now)
            n = min(4, cap - cursor)
            if n <= 0:
                break
            sl = slice(cursor, cursor + n)
            dyn_v[sl, 0], dyn_v[sl, 1], dyn_v[sl, 2] = sv0[:n], sv1[:n], sv2[:n]
            dyn_prev[sl] = dyn_v[sl]
            dyn_uv[sl] = suv[:n]
            dyn_tex[sl] = texnum
            dyn_flags[sl] = materials.MAT_FLAGS_SPRITE
            dyn_valid[sl] = True
            cursor += n

        # particles (tetrahedra, quake_helpers.cpp:50-216)
        if self.particles is not None and cursor < cap:
            pv0, pv1, pv2, palb, pemm = particles_to_soup(
                self.particles[0],
                self.particles[1],
                reproducible=self.reproducible,
            )
            n = min(pv0.shape[0], cap - cursor)
            sl = slice(cursor, cursor + n)
            dyn_v[sl, 0], dyn_v[sl, 1], dyn_v[sl, 2] = pv0[:n], pv1[:n], pv2[:n]
            dyn_prev[sl] = dyn_v[sl]
            dyn_flags[sl] = materials.MAT_FLAGS_SOLID
            dyn_salb[sl] = palb[:n]
            dyn_semm[sl] = pemm[:n]
            dyn_valid[sl] = True
            cursor += n

        return dict(
            v=dyn_v, prev=dyn_prev, uv=dyn_uv, tex=dyn_tex, fb=dyn_fb,
            flags=dyn_flags, salb=dyn_salb, semm=dyn_semm, valid=dyn_valid,
        )

    def _uniforms(self) -> Uniforms:
        # camera
        base_u = self.static_bundle.uniforms
        if self.camera_path is not None:
            pos, fwd, up = self.camera_path(self.time)
            ppos, pfwd, pup = self.camera_path(self.prev_time)
        else:
            pos, fwd, up = self._base_cam
            ppos, pfwd, pup = pos, fwd, up
        f32 = lambda v: host_to_device(np.asarray(v, np.float32), self.device)
        uniforms = base_u._replace(
            cam_x=f32(pos),
            cam_w=f32(fwd),
            cam_u=f32(up),
            prev_cam_x=f32(ppos),
            prev_cam_w=f32(pfwd),
            prev_cam_u=f32(pup),
            cl_time=f32(self.time),
            time_diff=f32(
                max(self.time - self.prev_time, 1e-6)
                if self.time != self.prev_time
                else 1.0
            ),
            frame=int(self.frame) & 0xFFFFFFFF,
        )
        return uniforms


def orbit_camera(center, radius, height, period=8.0, look_at=None):
    """A simple scripted flythrough (≈ demo-playback camera)."""
    center = np.asarray(center, np.float32)
    look_at = np.asarray(look_at if look_at is not None else center, np.float32)

    def path(t):
        a = 2.0 * math.pi * t / period
        pos = center + np.asarray(
            [radius * math.cos(a), radius * math.sin(a), height], np.float32
        )
        fwd = look_at - pos
        fwd = fwd / np.linalg.norm(fwd)
        up = np.asarray([0.0, 0.0, 1.0], np.float32)
        return pos, fwd, up

    return path
