"""Weighted reservoir sampling library (SoA, batched over pixels).

Port of merian_quake_tpu/render/restir/reservoir.py (the reference's
restir_di_reservoir.glsl.h). The one-sample estimator is
<L> = f(y)/p_target · W  with W = w_sum/(M·p_target) after finalize.
``M`` is int32; ``y_flags`` holds a u32 value in an int64 tensor (the
port's convention for u32, ops/rng.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import rng as rng_ops

FLAG_VALID = 1


class Reservoir(NamedTuple):
    """ReSTIRDIReservoir SoA; sample y inlined (restir_di_reservoir.glsl.h)."""

    M: torch.Tensor  # i32[N]
    w: torch.Tensor  # f32[N] w_sum (RIS) or W (finalized)
    p_target: torch.Tensor  # f32[N]
    y_pos: torch.Tensor  # f32[N, 3]
    y_normal: torch.Tensor  # f32[N, 3]
    y_mv: torch.Tensor  # f32[N, 3] sample motion
    y_T: torch.Tensor  # f32[N] sample timestamp
    y_radiance: torch.Tensor  # f32[N, 3]
    y_flags: torch.Tensor  # u32 value (int64) [N]


def reservoir_init(n: int, device="cuda") -> Reservoir:
    z = lambda *s: torch.zeros(s, device=device)
    return Reservoir(
        M=torch.zeros((n,), dtype=torch.int32, device=device),
        w=z(n),
        p_target=z(n),
        y_pos=z(n, 3),
        y_normal=z(n, 3),
        y_mv=z(n, 3),
        y_T=z(n),
        y_radiance=z(n, 3),
        y_flags=torch.zeros((n,), dtype=torch.int64, device=device),
    )


def _select_y(take, a: Reservoir, b_pos, b_normal, b_mv, b_T, b_rad, b_flags):
    t3 = take[..., None]
    return a._replace(
        y_pos=torch.where(t3, b_pos, a.y_pos),
        y_normal=torch.where(t3, b_normal, a.y_normal),
        y_mv=torch.where(t3, b_mv, a.y_mv),
        y_T=torch.where(take, b_T, a.y_T),
        y_radiance=torch.where(t3, b_rad, a.y_radiance),
        y_flags=torch.where(take, b_flags, a.y_flags),
    )


def add_sample(r: Reservoir, rng_state, mask, pos, normal, mv, T, radiance, flags,
               p_sample, p_target):
    """restir_di_reservoir_add_sample, masked per lane."""
    w = torch.where(mask, p_target / torch.clamp_min(p_sample, 1e-20), 0.0)
    new_wsum = r.w + w
    new_m = r.M + mask.to(torch.int32)
    rng_state, u = rng_ops.uniform(rng_state)
    take = mask & (u * new_wsum < w)
    out = r._replace(
        M=new_m, w=new_wsum, p_target=torch.where(take, p_target, r.p_target)
    )
    out = _select_y(take, out, pos, normal, mv, T, radiance, flags)
    return rng_state, out, take


def combine_finalized(r: Reservoir, rng_state, other: Reservoir, p_target_xy, mask=None):
    """restir_di_reservoir_combine_finalized (other.w holds W)."""
    if mask is None:
        mask = torch.ones(r.M.shape, dtype=torch.bool, device=r.M.device)
    w = torch.where(mask, p_target_xy * other.w * other.M.float(), 0.0)
    new_m = r.M + torch.where(mask, other.M, 0)
    new_wsum = r.w + w
    rng_state, u = rng_ops.uniform(rng_state)
    take = mask & (u * new_wsum < w)
    out = r._replace(
        M=new_m, w=new_wsum, p_target=torch.where(take, p_target_xy, r.p_target)
    )
    out = _select_y(
        take, out, other.y_pos, other.y_normal, other.y_mv, other.y_T,
        other.y_radiance, other.y_flags,
    )
    return rng_state, out, take


def finalize(r: Reservoir) -> Reservoir:
    """w_sum → W = w_sum/(M·p_target) (eq. 6)."""
    denom = r.M.float() * r.p_target
    return r._replace(w=torch.where(denom > 0.0, r.w / torch.clamp_min(denom, 1e-30), 0.0))


def finalize_custom(r: Reservoir, numerator, denominator) -> Reservoir:
    denom = denominator * r.p_target
    return r._replace(
        w=torch.where(denom > 0.0, r.w * numerator / torch.clamp_min(denom, 1e-30), 0.0)
    )


def discard(r: Reservoir, mask) -> Reservoir:
    """restir_di_reservoir_discard on masked lanes."""
    return r._replace(
        w=torch.where(mask, 0.0, r.w),
        y_flags=torch.where(mask, 0, r.y_flags),
        y_radiance=torch.where(mask[..., None], 0.0, r.y_radiance),
    )


def valid(r: Reservoir):
    return (r.y_flags & FLAG_VALID) > 0
