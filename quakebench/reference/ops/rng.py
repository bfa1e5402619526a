"""Counter-based / stateful RNG streams (pcg4d seeding + xorshift32).

Port of merian_quake_tpu/ops/rng.py, bit-exact. u32 values are held in
int64 tensors in [0, 2^32): torch has no u32 shifts or adds on every
device, so each op is done in int64 and masked back to 32 bits. Products
are split so that no intermediate leaves int64's signed range.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
# 1/2^32 — maps u32 to [0, 1).
_INV_U32 = 2.3283064365386963e-10


def _u32(x, like: torch.Tensor) -> torch.Tensor:
    """u32 value(s) as int64 on ``like``'s device (a Python int becomes a
    device-side fill, not a stalling host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.int64) & _M32
    return torch.full((), int(x) & _M32, dtype=torch.int64, device=like.device)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for u32 values, without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x, y, z, w):
    x = (x + _mul32(y, w)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    w = (w + _mul32(y, z)) & _M32
    return x, y, z, w


def pcg4d(v: torch.Tensor) -> torch.Tensor:
    """PCG4D hash (Jarzynski & Olano, JCGT 2020). ``v``: u32[..., 4]."""
    v = _u32(v, v)
    v = (_mul32(v, 1664525) + 1013904223) & _M32
    x, y, z, w = _mix(*v.unbind(-1))
    v = torch.stack([x, y, z, w], dim=-1)
    v = v ^ (v >> 16)
    x, y, z, w = _mix(*v.unbind(-1))
    return torch.stack([x, y, z, w], dim=-1)


def seed_pixel(px: torch.Tensor, py: torch.Tensor, frame, seed) -> torch.Tensor:
    """Per-pixel stream seed: pcg4d16(pixel, frame, SEED) → u32 state."""
    parts = torch.broadcast_tensors(
        _u32(px, px), _u32(py, px), _u32(frame, px), _u32(seed, px)
    )
    h = pcg4d(torch.stack(parts, dim=-1))[..., 0]
    # Avoid the xorshift32 fixed point at 0.
    return torch.where(h == 0, 0x9E3779B9, h)


def xorshift32_raw(state: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step. Returns the new state (also the raw sample)."""
    state = _u32(state, state)
    state = state ^ ((state << 13) & _M32)
    state = state ^ (state >> 17)
    state = state ^ ((state << 5) & _M32)
    return state


def uniform(state: torch.Tensor):
    """Draw one float32 uniform in [0, 1). Returns (new_state, u)."""
    state = xorshift32_raw(state)
    return state, state.to(torch.float32) * _INV_U32


def uniform2(state: torch.Tensor):
    state, a = uniform(state)
    state, b = uniform(state)
    return state, torch.stack([a, b], dim=-1)


def uniform3(state: torch.Tensor):
    state, a = uniform(state)
    state, b = uniform(state)
    state, c = uniform(state)
    return state, torch.stack([a, b, c], dim=-1)


def uniform4(state: torch.Tensor):
    state, ab = uniform2(state)
    state, cd = uniform2(state)
    return state, torch.cat([ab, cd], dim=-1)
