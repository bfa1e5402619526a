"""32-bit octahedral unit-vector encoding.

Port of merian_quake_tpu/ops/octahedral.py: two 16-bit snorm
components packed into one u32, held in an int64 tensor.
"""
from __future__ import annotations

import torch


def _oct_wrap(v: torch.Tensor) -> torch.Tensor:
    # (1 - |v.yx|) * sign-ish(v.xy); sign(0) must map to +1 here.
    s = torch.where(v >= 0.0, 1.0, -1.0)
    return (1.0 - v.flip(-1).abs()) * s


def to_oct(n: torch.Tensor) -> torch.Tensor:
    """Unit vector [..., 3] → octahedral uv in [-1, 1]^2."""
    denom = n[..., 0].abs() + n[..., 1].abs() + n[..., 2].abs()
    p = n[..., :2] / torch.clamp_min(denom, 1e-20)[..., None]
    return torch.where((n[..., 2] < 0.0)[..., None], _oct_wrap(p), p)


def from_oct(uv: torch.Tensor) -> torch.Tensor:
    """Octahedral uv in [-1, 1]^2 → unit vector [..., 3]."""
    x, y = uv[..., 0], uv[..., 1]
    z = 1.0 - x.abs() - y.abs()
    t = torch.clamp_min(-z, 0.0)
    x = x + torch.where(x >= 0.0, -t, t)
    y = y + torch.where(y >= 0.0, -t, t)
    v = torch.stack([x, y, z], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def encode_normal(n: torch.Tensor) -> torch.Tensor:
    """Unit vector [..., 3] → u32 value (int64 tensor)."""
    uv = torch.clamp(to_oct(n), -1.0, 1.0)
    q = torch.round((uv * 0.5 + 0.5) * 65535.0).to(torch.int64)
    return q[..., 0] | (q[..., 1] << 16)


def decode_normal(enc: torch.Tensor) -> torch.Tensor:
    """u32 value (int64 tensor) → unit vector [..., 3]."""
    enc = enc.to(torch.int64)
    u = (enc & 0xFFFF).float() / 65535.0 * 2.0 - 1.0
    v = ((enc >> 16) & 0xFFFF).float() / 65535.0 * 2.0 - 1.0
    return from_oct(torch.stack([u, v], dim=-1))
