"""Temporal anti-aliasing with neighborhood clamping.

Port of merian_quake_tpu/post/taa.py (the TAA stage inside merian's SVGF
node): reproject the previous output along motion vectors, clamp it to
the 3×3 neighborhood min/max of the current frame (ghosting
suppression), and blend.
"""
from __future__ import annotations

import torch

from .accumulate import reproject
from .svgf import _shift


def taa(prev_out, cur, mv, blend_alpha=0.1):
    """prev_out/cur: f32[H, W, 3]; mv: f32[H, W, 2]. Returns new output."""
    hist, valid = reproject(prev_out, mv, fallback=cur)
    lo = cur
    hi = cur
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift(cur, dy, dx)
            lo = torch.minimum(lo, s)
            hi = torch.maximum(hi, s)
    hist = torch.minimum(torch.maximum(hist, lo), hi)
    out = hist + (cur - hist) * blend_alpha
    return torch.where(valid[..., None], out, cur)
