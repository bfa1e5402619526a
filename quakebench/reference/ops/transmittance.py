"""Homogeneous-medium transmittance and free-flight distance sampling.

Port of merian_quake_tpu/ops/transmittance.py: fog with extinction
``mu_t`` truncated at ``max_t`` (vacuum beyond).
"""
from __future__ import annotations

import torch

from .linalg import as_f32 as _f32


def transmittance(t, mu_t, max_t):
    """exp(-mu_t * min(t, max_t))."""
    return torch.exp(-_f32(mu_t, t) * torch.minimum(t, _f32(max_t, t)))


def xi_max(mu_t, max_t):
    """CDF mass of scattering inside [0, max_t]: 1 - exp(-mu_t*max_t)."""
    return -torch.expm1(-mu_t * max_t)


def sample(xi, mu_t, max_t):
    """Truncated free-flight sampling: t = -log(1 - xi)/mu_t, ≤ max_t."""
    mu_t = torch.clamp_min(_f32(mu_t, xi), 1e-12)
    t = -torch.log1p(-torch.clamp(xi, 0.0, 1.0 - 1e-7)) / mu_t
    return torch.minimum(t, _f32(max_t, t))


def pdf(t, mu_t, max_t):
    """Density of :func:`sample` when xi ~ U[0, xi_max)."""
    mu_t = torch.clamp_min(_f32(mu_t, t), 1e-12)
    xm = torch.clamp_min(xi_max(mu_t, max_t), 1e-12)
    return torch.where(
        t <= max_t, mu_t * torch.exp(-mu_t * t) / xm, torch.zeros_like(t * mu_t)
    )
