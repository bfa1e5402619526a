"""Automatic exposure.

Port of merian_quake_tpu/post/exposure.py (merian's Exposure node in
auto mode): scales the HDR image by key / exp(mean(log(luminance))), the
classic Reinhard log-average key.
"""
from __future__ import annotations

import torch

from ..ops import color as color_ops
from ..ops.linalg import as_f32


def auto_exposure(img, key=0.18, eps=1e-4):
    """img: f32[H, W, 3 or 4]; returns (scaled rgb, scale) with the scale
    a 0-d tensor on the image's device."""
    rgb = img[..., :3]
    lum = color_ops.yuv_luminance(rgb)
    log_avg = torch.exp(torch.log(lum + eps).mean())
    scale = key / torch.clamp_min(log_avg, eps)
    return rgb * scale, scale


def manual_exposure(img, iso_scale=1.0):
    """img scaled by ``iso_scale``; returns (scaled rgb, scale) with the
    scale a 0-d tensor on the image's device, made by a fill (no
    host-to-device copy inside a frame)."""
    scale = as_f32(iso_scale, img)
    return img[..., :3] * scale, scale
