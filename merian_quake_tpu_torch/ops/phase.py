"""Phase functions: Henyey–Greenstein and Draine.

Port of merian_quake_tpu/ops/phase.py, the parts the volume pass uses.
The Draine phase is parameterized by (g, alpha), which the volume pass
computes from a fog particle size (``VolumeConfig.draine_g`` /
``draine_a``). Scalar parameters are rounded to f32 and combined in f32
on the host, as the JAX package's f32 graph combines them.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import linalg

INV_4PI = 1.0 / (4.0 * math.pi)
DRAINE_TABLE_SIZE = 1024


def hg_pdf(cos_theta, g):
    g = np.float32(g)
    c0, c1 = float(np.float32(1.0) + g * g), float(np.float32(2.0) * g)
    scale = float(np.float32(INV_4PI) * (np.float32(1.0) - g * g))
    return scale / torch.pow(torch.clamp_min(c0 - c1 * cos_theta, 1e-12), 1.5)


def draine_pdf(cos_theta, g, alpha):
    """Draine (1atm) phase: HG * (1 + alpha cos^2) / (1 + alpha(1+2g^2)/3)."""
    g, a = np.float32(g), np.float32(alpha)
    norm = float(np.float32(1.0) + a * (np.float32(1.0) + np.float32(2.0) * g * g) / np.float32(3.0))
    return hg_pdf(cos_theta, g) * (1.0 + float(a) * cos_theta * cos_theta) / norm


def draine_inverse_cdf_table(g, alpha, size=DRAINE_TABLE_SIZE) -> np.ndarray:
    """Tabulated inverse CDF of cos(theta) for the Draine phase, built on
    the host in float64: the closed-form inversion cancels
    catastrophically in float32 at strong anisotropy.

    Returns float32[size] mapping u in [0,1) (left bin edges) → cos_t.
    """
    g = float(g)
    alpha = float(alpha)
    n_fine = 1 << 14
    cos_grid = np.linspace(-1.0, 1.0, n_fine, dtype=np.float64)
    denom = np.maximum(1.0 + g * g - 2.0 * g * cos_grid, 1e-12)
    hg = (1.0 - g * g) / (4.0 * np.pi * np.power(denom, 1.5))
    norm_d = 1.0 + alpha * (1.0 + 2.0 * g * g) / 3.0
    p = hg * (1.0 + alpha * cos_grid * cos_grid) / norm_d
    # CDF over cos via trapezoid; normalized (pdf integrates over sphere
    # to 1 => over cos with 2*pi azimuth factor).
    cdf = np.concatenate([[0.0], np.cumsum((p[1:] + p[:-1]) * 0.5 * np.diff(cos_grid))])
    cdf /= cdf[-1]
    u = (np.arange(size, dtype=np.float64) + 0.5) / size
    return np.interp(u, cdf, cos_grid).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_table(g: float, alpha: float, device: str) -> torch.Tensor:
    """The inverse-CDF table of (g, alpha), built and copied to ``device``
    once: a frame then pays no host build and no host-to-device copy."""
    return torch.from_numpy(draine_inverse_cdf_table(g, alpha)).to(device)


def draine_sample_cos_table(u1, table):
    """Sample cos(theta) by linear interpolation into a precomputed table."""
    size = table.shape[0]
    x = torch.clamp(u1 * size - 0.5, 0.0, size - 1.0)
    i0 = torch.floor(x).to(torch.int64)
    i1 = torch.clamp_max(i0 + 1, size - 1)
    w = x - i0.to(torch.float32)
    return torch.clamp(table[i0] * (1.0 - w) + table[i1] * w, -1.0, 1.0)


def draine_sample_cos(u1, g, alpha, table=None):
    """Sample cos(theta) ~ Draine(g, alpha), through the table of (g,
    alpha) kept on ``u1``'s device unless one is given."""
    if table is None:
        table = _device_table(float(g), float(alpha), str(u1.device))
    return draine_sample_cos_table(u1, table)


def sample_dir(w: torch.Tensor, cos_theta, u_phi) -> torch.Tensor:
    """Direction at angle acos(cos_theta) around axis w, azimuth u_phi."""
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * math.pi * u_phi
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_theta], dim=-1)
    return linalg.frame_to_world(w, local)
