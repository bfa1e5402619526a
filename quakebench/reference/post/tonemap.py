"""Tonemapping (port of merian_quake_tpu/post/tonemap.py): extended
Reinhard in luminance, L_out = L (1 + L/white²) / (1 + L), then sRGB."""
from __future__ import annotations

import torch

from ..ops import color as color_ops


def tonemap_reinhard_extended(rgb, white=4.0, srgb=True):
    lum = color_ops.yuv_luminance(rgb)[..., None]
    lum = torch.clamp_min(lum, 1e-8)
    l_out = lum * (1.0 + lum / (white * white)) / (1.0 + lum)
    out = torch.clamp(rgb * (l_out / lum), 0.0, 1.0)
    if srgb:
        out = color_ops.linear_to_srgb(out)
    return out
