"""Unidirectional path tracer (the reference's REFERENCE_MODE).

Port of merian_quake_tpu/render/pt.py (mcpg.comp with
MERIAN_QUAKE_REFERENCE_MODE == 1): per-pixel xorshift32 streams seeded
by pcg4d16(pixel, frame, seed), ``spp`` paths of at most
``max_path_length`` segments continued by GGX+diffuse BSDF sampling,
termination on found emission / dead throughput, contribution f/p with
NaN/Inf rejection, luminance² second moment in the alpha channel. The
per-pixel loops are masked lane updates, the spp and segment loops
plain Python loops.
"""
from __future__ import annotations

import torch

from ..accel.build import AccelScene
from ..models.types import RenderConfig, TextureAtlas, Uniforms
from ..ops import bsdf, color as color_ops, linalg, rng as rng_ops
from . import layout
from .gbuffer import GBufferOutput
from .hit import Hit, decompress_hit
from .trace import trace_ray


def sorts_bounce_rays(schedule) -> bool:
    """Bounce rays are traced as they lie: on the card a coherence sort
    costs more than it saves. A trace schedule with a target key
    (accel.woop.TraceSchedule) is a sort by that key, and asks for it."""
    return schedule is not None and bool(schedule.target_key)


def _where_hit(mask, a: Hit, b: Hit) -> Hit:
    m3 = mask[..., None]
    return Hit(
        *[torch.where(m3 if x.dim() > 1 else mask, x, y) for x, y in zip(a, b)]
    )


def render_pt(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    gbuf: GBufferOutput,
    schedule=None,
    y0=0,
    rows: int | None = None,
) -> torch.Tensor:
    """Returns the irradiance image f32[H, W, 4] (rgb, second moment).

    RNG streams are seeded with the pixel coordinates. ``schedule``: the
    card's trace schedule (accel.woop.TraceSchedule). ``y0``/``rows``:
    the image-row slab (the image is then f32[rows, W, 4]).
    """
    W, H = config.width, config.height
    rows = H if rows is None else rows
    n = W * rows
    dev = accel.woop_w.device
    pxi, pyi = layout.gen_pixels(W, rows, y0=y0, device=dev)
    state = rng_ops.seed_pixel(pxi, pyi, uniforms.frame, config.seed)

    first_hit = decompress_hit(gbuf.hits)
    # mcpg.comp:43 — skip pixels whose first hit has (near) zero albedo
    pixel_live = (first_hit.albedo >= 1e-7).any(-1)

    irr = torch.zeros((n, 3), device=dev)
    m2 = torch.zeros((n,), device=dev)
    for _ in range(config.spp):
        cur = first_hit
        throughput = torch.ones((n, 3), device=dev)
        f = torch.zeros((n, 3), device=dev)
        p = torch.ones((n,), device=dev)
        done = ~pixel_live
        for _ in range(max(config.max_path_length - 1, 0)):
            state, u3 = rng_ops.uniform3(state)
            alpha = bsdf.roughness_to_alpha(cur.roughness)
            wo = bsdf.sample(cur.wi, cur.normal, alpha, u3)
            wodotn = linalg.dot(wo, cur.normal)
            below = (wodotn <= 1e-3) | (linalg.dot(wo, cur.geo_normal) <= 1e-3)
            active = ~done & ~below
            wo_p = bsdf.pdf(cur.wi, wo, cur.normal, alpha)

            # trace next segment (origin pulled back, mcpg.comp:144); the
            # rays go as they lie unless the schedule sorts them by its
            # target key
            origin = cur.pos - cur.wi * 1e-3
            res = trace_ray(
                accel, atlas, uniforms, origin, wo,
                bilinear=config.bilinear, features=config.features,
                sort_rays=sorts_bounce_rays(schedule), active=active, schedule=schedule,
            )

            micro = bsdf.eval_times_cos(cur.wi, wo, cur.normal, alpha)
            new_thr = throughput * micro[..., None]
            new_f = new_thr * res.contribution
            new_p = p * wo_p
            new_thr = new_thr * res.throughput * res.hit.albedo

            # commit updates only on active lanes
            throughput = torch.where(active[..., None], new_thr, throughput)
            f = torch.where(active[..., None], new_f, f)
            p = torch.where(active, new_p, p)
            cur = _where_hit(active, res.hit, cur)

            # termination (mcpg.comp:188-189)
            dead = (throughput < 1e-7).all(-1) | (f > 1e-7).any(-1)
            done = done | below | dead
        contrib = f / torch.clamp_min(p, 1e-30)[..., None]
        ok = torch.isfinite(contrib).all(-1)
        contrib = torch.where((ok & pixel_live)[..., None], contrib, 0.0)
        lum = color_ops.yuv_luminance(contrib)
        irr = irr + contrib
        m2 = m2 + lum * lum
    if config.spp > 0:
        irr = irr / config.spp
        m2 = m2 / config.spp
    return layout.flat_to_image(torch.cat([irr, m2[..., None]], dim=-1), W, rows)
