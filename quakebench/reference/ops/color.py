"""Color helpers: luminance, LDR→HDR emission boost, sRGB.

Port of merian_quake_tpu/ops/color.py.
"""
from __future__ import annotations

import torch


def yuv_luminance(rgb: torch.Tensor) -> torch.Tensor:
    """BT.709 luma of linear RGB [..., 3]."""
    return (
        0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]
    )


def ldr_to_hdr(color: torch.Tensor) -> torch.Tensor:
    """Heuristic emission boost for fullbright LDR texels:
    l = clamp(mean(c)^0.1, 0, 0.99); sqrt(c) * 2 * l/(1-l)."""
    mean = color.mean(-1, keepdim=True)
    l = torch.clamp(torch.pow(torch.clamp_min(mean, 0.0), 0.1), 0.0, 0.99)
    return torch.sqrt(torch.clamp_min(color, 0.0)) * 2.0 * l / (1.0 - l)


def oklch_to_rgb(lch: torch.Tensor) -> torch.Tensor:
    """OKLCh [..., 3] (L, C, h in radians) → linear sRGB [..., 3]
    (merian-shaders colors_oklch.glsl; the MCPG grid debug view).
    Ottosson's OKLab transform; the cubes are products, as XLA computes
    an integer power."""
    L = lch[..., 0]
    C = lch[..., 1]
    h = lch[..., 2]
    a = C * torch.cos(h)
    b = C * torch.sin(h)
    l_ = L + 0.3963377774 * a + 0.2158037573 * b
    m_ = L - 0.1055613458 * a - 0.0638541728 * b
    s_ = L - 0.0894841775 * a - 1.2914855480 * b
    l3, m3, s3 = l_ * l_ * l_, m_ * m_ * m_, s_ * s_ * s_
    r = 4.0767416621 * l3 - 3.3077115913 * m3 + 0.2309699292 * s3
    g = -1.2684380046 * l3 + 2.6097574011 * m3 - 0.3413193965 * s3
    bb = -0.0041960863 * l3 - 0.7034186147 * m3 + 1.7076147010 * s3
    return torch.clamp(torch.stack([r, g, bb], dim=-1), 0.0, 1.0)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(
        c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4)
    )


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(
        c <= 0.0031308, c * 12.92, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055
    )
