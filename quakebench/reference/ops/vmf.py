"""von Mises–Fisher distribution on S² — sample / pdf.

Port of merian_quake_tpu/ops/vmf.py (log1p/expm1 forms, stable for
kappa → 0 and kappa ≫ 1).
"""
from __future__ import annotations

import math

import torch

from . import linalg

MAX_KAPPA = 1e4


def pdf(w: torch.Tensor, mu: torch.Tensor, kappa) -> torch.Tensor:
    """vMF density; limits to uniform-sphere 1/(4*pi) as kappa → 0."""
    kappa = torch.clamp(linalg.as_f32(kappa, w), 0.0, MAX_KAPPA)
    c = linalg.dot(w, mu)
    small = kappa < 1e-4
    safe_kappa = torch.where(small, 1.0, kappa)
    norm = safe_kappa / (2.0 * math.pi * -torch.expm1(-2.0 * safe_kappa))
    dens = norm * torch.exp(safe_kappa * (c - 1.0))
    return torch.where(small, 1.0 / (4.0 * math.pi), dens)


def sample(mu: torch.Tensor, kappa, u: torch.Tensor) -> torch.Tensor:
    """Sample a direction ~ vMF(mu, kappa). u: [..., 2] uniforms."""
    kappa = torch.clamp(
        torch.broadcast_to(linalg.as_f32(kappa, u), u[..., 0].shape), 0.0, MAX_KAPPA
    )
    u0 = torch.clamp(u[..., 0], 1e-7, 1.0)
    small = kappa < 1e-4
    safe_kappa = torch.where(small, 1.0, kappa)
    logterm = torch.log(u0) + torch.log1p(
        (1.0 - u0) / u0 * torch.exp(-2.0 * safe_kappa)
    )
    cos_theta = torch.where(
        small,
        1.0 - 2.0 * u0,
        torch.clamp(1.0 + logterm / safe_kappa, -1.0, 1.0),
    )
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = 2.0 * math.pi * u[..., 1]
    local = torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta],
        dim=-1,
    )
    return linalg.frame_to_world(mu, local)


def kappa_from_mean_cos(r: torch.Tensor) -> torch.Tensor:
    """ML estimate kappa ≈ r(3 - r²)/(1 - r²)  (Banerjee et al. 2005)."""
    r = torch.clamp(r, 0.0, 0.9999999)
    return (3.0 * r - r * r * r) / (1.0 - r * r)
