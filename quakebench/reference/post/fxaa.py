"""FXAA 3.11-style anti-aliasing (console quality preset).

Port of merian_quake_tpu/post/fxaa.py (merian's FXAA node): luma-based
edge detection on LDR input and a blend toward the neighbor across the
edge.
"""
from __future__ import annotations

import torch

from ..ops import color as color_ops
from .svgf import _shift


def fxaa(rgb, contrast_threshold=0.0312, relative_threshold=0.125):
    """rgb: f32[H, W, 3] in [0, 1]. Returns anti-aliased image."""
    luma = color_ops.yuv_luminance(rgb)

    l_c = luma
    l_n = _shift(luma, -1, 0)
    l_s = _shift(luma, 1, 0)
    l_e = _shift(luma, 0, 1)
    l_w = _shift(luma, 0, -1)
    l_ne = _shift(luma, -1, 1)
    l_nw = _shift(luma, -1, -1)
    l_se = _shift(luma, 1, 1)
    l_sw = _shift(luma, 1, -1)

    l_min = torch.minimum(
        l_c, torch.minimum(torch.minimum(l_n, l_s), torch.minimum(l_e, l_w))
    )
    l_max = torch.maximum(
        l_c, torch.maximum(torch.maximum(l_n, l_s), torch.maximum(l_e, l_w))
    )
    contrast = l_max - l_min
    threshold = torch.clamp_min(relative_threshold * l_max, contrast_threshold)
    active = contrast >= threshold

    # blend factor from neighborhood average
    avg = (2.0 * (l_n + l_s + l_e + l_w) + l_ne + l_nw + l_se + l_sw) / 12.0
    blend = torch.clamp((avg - l_c).abs() / torch.clamp_min(contrast, 1e-8), 0.0, 1.0)
    blend = torch.square(torch.clamp(blend * blend * (3.0 - 2.0 * blend), 0.0, 1.0))

    # edge direction: horizontal vs vertical contrast
    horiz = (
        (l_n + l_s - 2 * l_c).abs() * 2
        + (l_ne + l_se - 2 * l_e).abs()
        + (l_nw + l_sw - 2 * l_w).abs()
    )
    vert = (
        (l_e + l_w - 2 * l_c).abs() * 2
        + (l_ne + l_nw - 2 * l_n).abs()
        + (l_se + l_sw - 2 * l_s).abs()
    )
    is_horiz = horiz >= vert
    # pick the higher-gradient side along the edge normal
    pos_l = torch.where(is_horiz, l_s, l_e)
    neg_l = torch.where(is_horiz, l_n, l_w)
    pick_pos = (pos_l - l_c).abs() >= (neg_l - l_c).abs()

    pos_img = torch.where(is_horiz[..., None], _shift(rgb, 1, 0), _shift(rgb, 0, 1))
    neg_img = torch.where(is_horiz[..., None], _shift(rgb, -1, 0), _shift(rgb, 0, -1))
    neighbor = torch.where(pick_pos[..., None], pos_img, neg_img)

    w = torch.where(active, blend, 0.0)[..., None]
    return rgb * (1.0 - w) + neighbor * w
