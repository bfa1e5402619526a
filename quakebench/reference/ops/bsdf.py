"""GGX + diffuse mix BSDF — sample / pdf / eval×cos.

Port of merian_quake_tpu/ops/bsdf.py: GGX with Smith separable
shadowing and VNDF sampling (Heitz 2018), Lambert diffuse (albedo
applied by the caller), alpha = roughness². ``wi`` points TOWARD the
surface, ``wo`` away from it.
"""
from __future__ import annotations

import math

import torch

from . import linalg

# Scalar specular reflectance; reference passes 0.02 at mcpg.comp:154.
SPEC_WEIGHT = 0.02


def roughness_to_alpha(roughness):
    return torch.square(roughness)


def _ggx_lambda(cos_t, alpha):
    """Smith Lambda for GGX; cos_t > 0."""
    c2 = torch.square(torch.clamp(cos_t, 1e-6, 1.0))
    t2 = (1.0 - c2) / c2
    return 0.5 * (torch.sqrt(1.0 + torch.square(alpha) * t2) - 1.0)


def _g1(cos_t, alpha):
    return 1.0 / (1.0 + _ggx_lambda(cos_t, alpha))


def _d_ggx(cos_h, alpha):
    a2 = torch.square(alpha)
    c2 = torch.square(torch.clamp(cos_h, 0.0, 1.0))
    denom = c2 * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(math.pi * denom * denom, 1e-12)


def _clamp_view(v):
    # Clamp below-horizon views to grazing and renormalize (keeps
    # sampled/evaluated directions unit-length for backfacing hits).
    return linalg.normalize(
        torch.cat([v[..., :2], torch.clamp_min(v[..., 2:3], 1e-6)], dim=-1)
    )


def _sample_vndf(v_local, alpha, u):
    """Sample a GGX half-vector via the VNDF (Heitz 2018 listing)."""
    a = alpha[..., None]
    vh = linalg.normalize(
        v_local * torch.cat([a, a, torch.ones_like(a)], dim=-1)
    )
    lensq = torch.square(vh[..., 0]) + torch.square(vh[..., 1])
    inv = 1.0 / torch.sqrt(torch.clamp_min(lensq, 1e-20))
    t1 = torch.where(
        (lensq > 1e-12)[..., None],
        torch.stack(
            [-vh[..., 1] * inv, vh[..., 0] * inv, torch.zeros_like(inv)], dim=-1
        ),
        torch.stack([torch.ones_like(inv), torch.zeros_like(inv), torch.zeros_like(inv)], dim=-1),
    )
    t2 = linalg.cross(vh, t1)
    r = torch.sqrt(torch.clamp(u[..., 0], 0.0, 1.0))
    phi = 2.0 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    h = torch.stack(
        [a[..., 0] * nh[..., 0], a[..., 0] * nh[..., 1],
         torch.clamp_min(nh[..., 2], 1e-6)],
        dim=-1,
    )
    return linalg.normalize(h)


def _spec_pdf_local(v, wo, alpha):
    """VNDF pdf of wo given view v (both local, away from surface)."""
    h = linalg.normalize(v + wo)
    d = _d_ggx(h[..., 2], alpha)
    g1 = _g1(v[..., 2], alpha)
    return g1 * d / torch.clamp_min(4.0 * v[..., 2], 1e-8)


def sample(wi, n, alpha, u3, spec_weight=SPEC_WEIGHT):
    """Sample wo from the mix. u3: [..., 3] uniforms. Returns wo (world)."""
    v = _clamp_view(linalg.world_to_frame(n, -wi))
    h = _sample_vndf(v, alpha, u3[..., 1:3])
    wo_spec = linalg.reflect(-v, h)
    phi = 2.0 * math.pi * u3[..., 1]
    r = torch.sqrt(torch.clamp(u3[..., 2], 0.0, 1.0))
    wo_diff = torch.stack(
        [
            r * torch.cos(phi),
            r * torch.sin(phi),
            torch.sqrt(torch.clamp_min(1.0 - u3[..., 2], 0.0)),
        ],
        dim=-1,
    )
    pick_spec = u3[..., 0] < spec_weight
    wo_local = torch.where(pick_spec[..., None], wo_spec, wo_diff)
    return linalg.frame_to_world(n, wo_local)


def pdf(wi, wo, n, alpha, spec_weight=SPEC_WEIGHT):
    """Mixture pdf of wo (world), consistent with :func:`sample`."""
    v = _clamp_view(linalg.world_to_frame(n, -wi))
    o = linalg.world_to_frame(n, wo)
    cos_o = torch.clamp_min(o[..., 2], 0.0)
    p_diff = cos_o / math.pi
    p_spec = torch.where(cos_o > 0.0, _spec_pdf_local(v, o, alpha), 0.0)
    return spec_weight * p_spec + (1.0 - spec_weight) * p_diff


def eval_times_cos(wi, wo, n, alpha, spec_weight=SPEC_WEIGHT):
    """Scalar BSDF × cos(wo, n), WITHOUT albedo."""
    v = _clamp_view(linalg.world_to_frame(n, -wi))
    o = linalg.world_to_frame(n, wo)
    cos_o = torch.clamp_min(o[..., 2], 0.0)
    diff = (1.0 - spec_weight) * cos_o / math.pi
    h = linalg.normalize(v + o)
    d = _d_ggx(h[..., 2], alpha)
    g = _g1(v[..., 2], alpha) * _g1(torch.clamp_min(o[..., 2], 1e-6), alpha)
    spec = spec_weight * d * g / torch.clamp_min(4.0 * v[..., 2], 1e-8)
    return diff + torch.where(cos_o > 0.0, spec, 0.0)
