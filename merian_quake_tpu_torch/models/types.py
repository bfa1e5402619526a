"""Core scene/uniform types: NamedTuple containers of torch tensors.

Port of merian_quake_tpu/models/types.py. The layout is the same: one
world-space triangle soup in structure-of-arrays form, padded to a
CLUSTER_SIZE multiple, plus a texture atlas and per-frame uniforms.
Containers are built on the host and moved to a device once with
``.to(device)``; every tensor of one container lives on one device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import materials

# Triangles are grouped into fixed-size clusters for the intersection
# structure (accel/). Scene arrays are padded to a multiple.
CLUSTER_SIZE = 64


def host_to_device(a, device) -> torch.Tensor:
    """A host (numpy) array as a tensor on ``device``. To the card the
    copy goes through pinned memory without blocking the host: torch's
    caching host allocator keeps the pinned block until the copy has
    run, so the caller may reuse ``a`` at once."""
    t = torch.from_numpy(np.array(a, order="C"))  # a 0-d array stays 0-d
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_device(x, device):
    """Move every tensor in a (nested) NamedTuple/tuple to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_device(v, device) for v in x])
    if isinstance(x, tuple):
        return tuple(to_device(v, device) for v in x)
    return x


class TextureAtlas(NamedTuple):
    """All scene textures packed into one 2D atlas with a mip chain.

    ``data``: f32[H, W, 4] linear RGBA level 0. ``mips``: tuple of
    coarser levels. ``table``: i32[MAX_TEX, 4] = (x, y, w, h) per
    texture id at level 0; w == 0 marks unused. ``flat``: all levels'
    texels concatenated row-major, (sum_l H_l*W_l, 4).
    """

    data: torch.Tensor
    table: torch.Tensor
    mips: tuple = ()
    flat: torch.Tensor | None = None

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def num_levels(self) -> int:
        return 1 + len(self.mips)

    def to(self, device) -> "TextureAtlas":
        return to_device(self, device)


class Scene(NamedTuple):
    """World-space triangle soup + materials (SoA, leading dim T)."""

    v0: torch.Tensor  # f32[T, 3]
    v1: torch.Tensor
    v2: torch.Tensor
    pv0: torch.Tensor  # previous-frame positions (motion vectors)
    pv1: torch.Tensor
    pv2: torch.Tensor
    st: torch.Tensor  # f32[T, 3, 2] per-corner UVs
    texnum: torch.Tensor  # i32[T] albedo texture id
    fb_texnum: torch.Tensor  # i32[T] fullbright texture (0 = none)
    normal_texnum: torch.Tensor  # i32[T] tangent normal map (0 = none)
    gloss_texnum: torch.Tensor  # i32[T] roughness map (0 = none)
    flags: torch.Tensor  # i32[T] MAT_FLAGS_*
    alpha: torch.Tensor  # f32[T]; < 0 → use texture alpha
    solid_albedo: torch.Tensor  # f32[T, 3] for MAT_FLAGS_SOLID
    solid_emission: torch.Tensor  # f32[T, 3]
    valid: torch.Tensor  # bool[T]

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]

    def to(self, device) -> "Scene":
        return to_device(self, device)


class Uniforms(NamedTuple):
    """Per-frame uniform data. ``frame`` and ``player`` are u32 values:
    each a Python int or, as in the JAX package, a device scalar (an
    int64 0-d tensor in [0, 2^32), :func:`device_scalars`), which a
    frame reads without a host round trip and a captured frame
    (renderer.compile_frame) takes anew on every replay; both forms give
    the same bits. Everything else is an f32/i32 tensor."""

    cam_x: torch.Tensor  # f32[3] camera position
    cam_w: torch.Tensor  # f32[3] forward
    cam_u: torch.Tensor  # f32[3] up
    prev_cam_x: torch.Tensor
    prev_cam_w: torch.Tensor
    prev_cam_u: torch.Tensor
    fov_tan_half: torch.Tensor  # f32[] tan of half horizontal fov
    mu_t: torch.Tensor  # f32[] fog extinction
    mu_s: torch.Tensor  # f32[3] fog scattering
    volume_max_t: torch.Tensor  # f32[] fog truncation distance
    cl_time: torch.Tensor  # f32[] game time
    time_diff: torch.Tensor  # f32[]
    frame: int | torch.Tensor  # u32 value
    sun_w: torch.Tensor  # f32[3] sun direction (toward the sun)
    sun_color: torch.Tensor  # f32[3]
    sky_classic: torch.Tensor  # i32[2] (back, front) texture ids; -1 = cubemap
    sky_cube: torch.Tensor  # i32[6] cubemap face ids
    player: int | torch.Tensor  # u32 PLAYER_FLAGS_*

    def to(self, device) -> "Uniforms":
        return to_device(self, device)


def device_scalars(uniforms: Uniforms) -> Uniforms:
    """``uniforms`` with ``frame`` and ``player`` as u32 device scalars
    (int64 0-d tensors masked to 32 bits) on the camera's device. A
    Python int becomes a device-side fill, not a host copy."""
    from ..ops.rng import _u32

    return uniforms._replace(frame=_u32(uniforms.frame, uniforms.cam_x),
                             player=_u32(uniforms.player, uniforms.cam_x))


def default_uniforms(
    cam_x=(0.0, 0.0, 0.0),
    cam_w=(1.0, 0.0, 0.0),
    cam_u=(0.0, 0.0, 1.0),
    fov_deg=90.0,
    mu_t=0.0,
    mu_s=(0.0, 0.0, 0.0),
    volume_max_t=1000.0,
    cl_time=0.0,
    time_diff=1.0,
    frame=0,
    sun_w=(0.577, 0.577, 0.577),
    sun_color=(0.0, 0.0, 0.0),
    sky_classic=(-1, -1),
    sky_cube=(-1, -1, -1, -1, -1, -1),
    player=0,
    prev_cam=None,
    device="cuda",
) -> Uniforms:
    f3 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    cam = (f3(cam_x), f3(cam_w), f3(cam_u))
    prev = tuple(f3(v) for v in prev_cam) if prev_cam is not None else cam
    sun = f3(sun_w)
    return Uniforms(
        cam_x=cam[0],
        cam_w=cam[1],
        cam_u=cam[2],
        prev_cam_x=prev[0],
        prev_cam_w=prev[1],
        prev_cam_u=prev[2],
        fov_tan_half=f3(float(np.tan(np.deg2rad(fov_deg) / 2.0))),
        mu_t=f3(mu_t),
        mu_s=f3(mu_s),
        volume_max_t=f3(volume_max_t),
        cl_time=f3(cl_time),
        time_diff=f3(time_diff),
        frame=int(frame) & 0xFFFFFFFF,
        sun_w=sun / torch.linalg.norm(sun),
        sun_color=f3(sun_color),
        sky_classic=torch.tensor(sky_classic, dtype=torch.int32, device=device),
        sky_cube=torch.tensor(sky_cube, dtype=torch.int32, device=device),
        player=int(player) & 0xFFFFFFFF,
    )


class SceneFeatures(NamedTuple):
    """Static scene capability flags: unused material paths are skipped
    (accel.build.scene_features derives them from the scene)."""

    sky_mode: str = "none"  # none | classic | cubemap
    has_alpha_tris: bool = True
    has_fb: bool = False
    has_gloss: bool = False
    has_warp: bool = False
    has_emissive_tex: bool = True
    has_normalmap: bool = False


class RenderConfig(NamedTuple):
    """Static render settings (same fields as the JAX package)."""

    width: int = 640
    height: int = 360
    spp: int = 1
    max_path_length: int = 3
    seed: int = 1337
    integrator: str = "pt"
    denoise: bool = False
    max_intersections: int = materials.MAX_INTERSECTIONS
    bilinear: bool = False
    features: "SceneFeatures" = SceneFeatures()


def build_scene_from_soup(
    v0,
    v1,
    v2,
    st=None,
    texnum=None,
    fb_texnum=None,
    normal_texnum=None,
    gloss_texnum=None,
    flags=None,
    alpha=None,
    solid_albedo=None,
    solid_emission=None,
    pv0=None,
    pv1=None,
    pv2=None,
    pad_to=None,
    device="cuda",
) -> Scene:
    """Host-side (numpy) scene assembly with padding to CLUSTER_SIZE
    (or to ``pad_to`` rows)."""
    v0 = np.asarray(v0, np.float32)
    n = v0.shape[0]

    def _default(x, shape, dtype, fill=0):
        if x is None:
            return np.full(shape, fill, dtype)
        return np.asarray(x, dtype)

    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    pv0 = np.asarray(pv0, np.float32) if pv0 is not None else v0.copy()
    pv1 = np.asarray(pv1, np.float32) if pv1 is not None else v1.copy()
    pv2 = np.asarray(pv2, np.float32) if pv2 is not None else v2.copy()
    st = _default(st, (n, 3, 2), np.float32)
    texnum = _default(texnum, (n,), np.int32)
    fb_texnum = _default(fb_texnum, (n,), np.int32)
    normal_texnum = _default(normal_texnum, (n,), np.int32)
    gloss_texnum = _default(gloss_texnum, (n,), np.int32)
    flags = _default(flags, (n,), np.int32)
    alpha = _default(alpha, (n,), np.float32, fill=-1.0)
    solid_albedo = _default(solid_albedo, (n, 3), np.float32)
    solid_emission = _default(solid_emission, (n, 3), np.float32)
    valid = np.ones((n,), bool)

    t_pad = pad_to if pad_to is not None else max(CLUSTER_SIZE, -(-n // CLUSTER_SIZE) * CLUSTER_SIZE)
    if t_pad < n:
        raise ValueError(f"pad_to={t_pad} < triangle count {n}")
    pad = t_pad - n

    def _pad(x, fill=0.0):
        if pad:
            width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
            x = np.pad(x, width, constant_values=fill)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return Scene(
        v0=_pad(v0),
        v1=_pad(v1),
        v2=_pad(v2),
        pv0=_pad(pv0),
        pv1=_pad(pv1),
        pv2=_pad(pv2),
        st=_pad(st),
        texnum=_pad(texnum),
        fb_texnum=_pad(fb_texnum),
        normal_texnum=_pad(normal_texnum),
        gloss_texnum=_pad(gloss_texnum),
        flags=_pad(flags),
        alpha=_pad(alpha, fill=-1.0),
        solid_albedo=_pad(solid_albedo),
        solid_emission=_pad(solid_emission),
        valid=_pad(valid, fill=False),
    )
