"""GBuffer pass: primary rays → first-hit data for the integrators.

Port of merian_quake_tpu/render/gbuffer.py (the reference's
gbuffer.comp): camera rays, first accepted hit, direct emission,
demodulated albedo, motion vectors, the compressed hit buffer and the
denoiser's packed extras (normal, linear z, depth gradients, z
velocity).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..accel.build import AccelScene
from ..models.types import RenderConfig, TextureAtlas, Uniforms
from ..ops import camera as cam_ops
from ..ops import linalg
from . import layout
from .hit import CompressedHit, compress_hit
from .trace import trace_ray


class GBufferOutput(NamedTuple):
    irradiance: torch.Tensor  # f32[H, W, 4] direct emission at first hit
    albedo: torch.Tensor  # f32[H, W, 4] demodulated albedo × throughput
    mv: torch.Tensor  # f32[H, W, 2] motion vector (prev_pixel - pixel)
    hits: CompressedHit  # [H*W] compressed first hits (buffer order)
    normal: torch.Tensor  # f32[H, W, 3] shading normal
    linear_z: torch.Tensor  # f32[H, W]
    z_grad: torch.Tensor  # f32[H, W, 2] depth gradients
    z_vel: torch.Tensor  # f32[H, W] z velocity


def _safe_div_dot(num, gn, r):
    den = linalg.dot(gn, r)
    return num / torch.where(den.abs() < 1e-6, 1e-6, den)


def render_gbuffer(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    schedule=None,
) -> GBufferOutput:
    """First hits of the camera rays (``schedule``: the card's trace
    schedule, accel.woop.TraceSchedule)."""
    W, H = config.width, config.height
    dev = accel.tri_attr.device
    pxi, pyi = layout.gen_pixels(W, H, device=dev)
    pxf = pxi.float()
    pyf = pyi.float()
    cam = (uniforms.cam_u, uniforms.cam_w, uniforms.fov_tan_half)
    wi = cam_ops.ray_dir(pxf, pyf, W, H, *cam)
    n = wi.shape[0]
    pos = uniforms.cam_x.expand(n, 3)

    # ray-cone mip selection on the first hit (gbuffer.comp:92-97)
    pixel_cone = 2.0 * uniforms.fov_tan_half / W
    res = trace_ray(
        accel, atlas, uniforms, pos, wi, bilinear=config.bilinear,
        pixel_cone=pixel_cone, features=config.features, schedule=schedule,
    )
    hit = res.hit
    ones = torch.ones((n, 1), device=dev)

    irradiance = layout.flat_to_image(
        torch.cat([res.contribution, ones], dim=-1), W, H
    )
    # albedo zeroed where emissive, × camera throughput (gbuffer.comp:107)
    emissive = (res.contribution >= 1e-5).any(-1)
    albedo = hit.albedo * torch.where(emissive[..., None], 0.0, 1.0) * res.throughput
    albedo_img = layout.flat_to_image(torch.cat([albedo, ones], dim=-1), W, H)

    # motion vector: reproject prev_pos into the previous camera
    old_px, old_py, _ = cam_ops.project(
        hit.prev_pos - uniforms.prev_cam_x, W, H,
        uniforms.prev_cam_u, uniforms.prev_cam_w, uniforms.fov_tan_half,
    )
    mv = layout.flat_to_image(
        torch.stack([old_px - pxf, old_py - pyf], dim=-1), W, H
    )

    # linear z + gradients from offset-pixel ray dirs
    linear_z = linalg.distance(hit.pos, uniforms.cam_x)
    r_x = cam_ops.ray_dir(pxf + 1.0, pyf, W, H, *cam)
    r_y = cam_ops.ray_dir(pxf, pyf + 1.0, W, H, *cam)
    gn = hit.geo_normal
    num = linalg.dot(gn, hit.pos - uniforms.cam_x)
    zg_x = _safe_div_dot(num, gn, r_x) - linear_z
    zg_y = _safe_div_dot(num, gn, r_y) - linear_z
    z_vel = linalg.distance(hit.prev_pos, uniforms.prev_cam_x) - linear_z

    return GBufferOutput(
        irradiance=irradiance,
        albedo=albedo_img,
        mv=mv,
        hits=compress_hit(hit),
        normal=layout.flat_to_image(hit.normal, W, H),
        linear_z=layout.flat_to_image(linear_z, W, H),
        z_grad=layout.flat_to_image(torch.stack([zg_x, zg_y], dim=-1), W, H),
        z_vel=layout.flat_to_image(z_vel, W, H),
    )
