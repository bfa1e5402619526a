"""Small vector-math helpers (frames, cosine sampling, normalization).

Port of merian_quake_tpu/ops/linalg.py. Batched over leading dims.
"""
from __future__ import annotations

import math

import torch

EPS = 1e-20


def as_f32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as an f32 tensor on ``like``'s device. A Python number becomes
    a device-side fill: copying it from the host would stall the stream
    until the device catches up."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def dot(a, b):
    return (a * b).sum(-1)


def norm(v):
    return torch.sqrt(torch.clamp_min(dot(v, v), 0.0))


def normalize(v):
    return v / torch.clamp_min(norm(v), EPS)[..., None]


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def distance(a, b):
    return norm(a - b)


def reflect(i, n):
    """GLSL reflect: i - 2*dot(n, i)*n (i points toward the surface)."""
    return i - 2.0 * dot(n, i)[..., None] * n


def make_frame(n: torch.Tensor):
    """Branchless ONB from a unit normal (Duff et al. 2017).

    Returns (t, b) with (t, b, n) right-handed orthonormal.
    """
    z = n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b_ = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b_, -sign * n[..., 0]],
        dim=-1,
    )
    b = torch.stack([b_, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, b


def frame_to_world(n, v_local):
    """Rotate local-frame vector (z = n) into world space."""
    t, b = make_frame(n)
    return (
        t * v_local[..., 0:1] + b * v_local[..., 1:2] + n * v_local[..., 2:3]
    )


def world_to_frame(n, v_world):
    t, b = make_frame(n)
    return torch.stack(
        [dot(t, v_world), dot(b, v_world), dot(n, v_world)], dim=-1
    )


def sample_cos(n: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere sample around n. u: [..., 2] uniforms."""
    phi = 2.0 * math.pi * u[..., 0]
    r = torch.sqrt(torch.clamp(u[..., 1], 0.0, 1.0))
    local = torch.stack(
        [
            r * torch.cos(phi),
            r * torch.sin(phi),
            torch.sqrt(torch.clamp_min(1.0 - u[..., 1], 0.0)),
        ],
        dim=-1,
    )
    return frame_to_world(n, local)


def cos_pdf(n, wo):
    return torch.clamp_min(dot(n, wo), 0.0) / math.pi
