"""Pinhole camera: ray generation and projection (reprojection for MVs).

Port of merian_quake_tpu/ops/camera.py; same conventions: ``w``
forward, ``u`` up, right = normalize(cross(w, u)), ``fov_tan_half`` is
the tangent of half the HORIZONTAL field of view, pixel (0, 0) is
top-left.
"""
from __future__ import annotations

import torch

from . import linalg


def basis(cam_u: torch.Tensor, cam_w: torch.Tensor):
    """Returns (right, up, fwd) orthonormal basis."""
    fwd = linalg.normalize(cam_w)
    right = linalg.normalize(linalg.cross(fwd, cam_u))
    up = linalg.cross(right, fwd)
    return right, up, fwd


def ray_dir(px, py, width, height, cam_u, cam_w, fov_tan_half):
    """World-space ray direction through pixel center (px+.5, py+.5)."""
    right, up, fwd = basis(cam_u, cam_w)
    x = (2.0 * (px.float() + 0.5) / width - 1.0) * fov_tan_half
    y = (
        (1.0 - 2.0 * (py.float() + 0.5) / height)
        * fov_tan_half
        * (height / width)
    )
    d = x[..., None] * right + y[..., None] * up + fwd
    return linalg.normalize(d)


def project(dir_world, width, height, cam_u, cam_w, fov_tan_half):
    """Inverse of :func:`ray_dir`: world direction → (px, py, forward dot)."""
    right, up, fwd = basis(cam_u, cam_w)
    dz = linalg.dot(dir_world, fwd)
    safe = torch.where(dz.abs() < 1e-8, 1e-8, dz)
    x = linalg.dot(dir_world, right) / safe / fov_tan_half
    y = linalg.dot(dir_world, up) / safe / (fov_tan_half * (height / width))
    px = (x + 1.0) * 0.5 * width - 0.5
    py = (1.0 - y) * 0.5 * height - 0.5
    return px, py, dz
