"""Phase functions: isotropic, Henyey–Greenstein and Draine.

Port of merian_quake_tpu/ops/phase.py, every public function of it.
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


def isotropic_pdf(shape=(), device="cuda"):
    return torch.full(shape, INV_4PI, dtype=torch.float32, device=device)


def sample_isotropic(u: torch.Tensor) -> torch.Tensor:
    """Uniform sphere direction from u: [..., 2]."""
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def hg_pdf(cos_theta, g):
    g = np.float32(g)
    c0, c1 = float(np.float32(1.0) + g * g), float(np.float32(2.0) * g)
    scale = float(np.float32(INV_4PI) * (np.float32(1.0) - g * g))
    return scale / torch.pow(torch.clamp_min(c0 - c1 * cos_theta, 1e-12), 1.5)


def hg_sample_cos(u1, g):
    """Sample cos(theta) ~ HG(g); ``g`` a number or an f32 tensor that
    broadcasts with ``u1``. Near-isotropic g (|g| < 1e-3) samples the
    sphere uniformly."""
    g = linalg.as_f32(g, u1)
    small = g.abs() < 1e-3
    safe_g = torch.where(small, 0.5, g)
    sqr = (1.0 - safe_g * safe_g) / (1.0 - safe_g + 2.0 * safe_g * u1)
    cos_t = (1.0 + safe_g * safe_g - sqr * sqr) / (2.0 * safe_g)
    return torch.clamp(torch.where(small, 1.0 - 2.0 * u1, cos_t), -1.0, 1.0)


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


def draine_params_from_particle_size(d):
    """Fog/cloud droplet diameter d (µm) → (g_hg_unused, g_d, alpha, w_d),
    host floats: the Mie fit for small water droplets (0.1 <= d <= 1.5)
    of Jendersie & d'Eon 2023 (render_mcpg.cpp:134-135)."""
    d = float(d)
    g_hg = np.exp(-0.0990567 / (d - 1.67154))
    g_d = np.exp(-2.20679 / (d + 3.91029) - 0.428934)
    a = np.exp(3.62489 - 8.29288 / (d + 5.52825))
    w_d = np.exp(-0.599085 / (d - 0.641583) - 0.665888)
    return g_hg, g_d, a, w_d
