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
