"""Single-scattering fog with distance + direction guiding.

Port of merian_quake_tpu/render/mcpg/volume.py: per screen-tile Gaussian
mixtures over camera-ray scatter distance (reservoir-selected,
defensively mixed with truncated transmittance sampling), scatter
directions guided by the SAME surface MC grids (normal = -view
direction) mixed with the Draine phase function, and scatter-style
forward projection of last frame's expected scatter depth into volume
motion vectors.

The draw order and the RNG consumption of ``render_volume`` follow the
JAX package line for line. The scatter rays are traced as they lie (no
coherence sort) unless a trace schedule sorts them by its target key.
Nothing here reads a device value from the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ...accel.build import AccelScene
from ...models.types import RenderConfig, TextureAtlas, Uniforms
from ...ops import (
    camera as cam_ops,
    color as color_ops,
    linalg,
    phase as phase_ops,
    rng as rng_ops,
    segments,
    transmittance as trans_ops,
    vmf,
)
from .. import layout
from ..gbuffer import GBufferOutput
from ..pt import sorts_bounce_rays
from ..trace import trace_ray
from . import grids
from .config import MCPGConfig, MCPGState
from .light_cache import lc_get
from .surface import (
    DistQueue, LCQueue, SurfaceResult, UpdateQueue, ZeroQueue, _i2f, _select_state, pack_tables,
)

DIST_ML_MAX_N = 1024
DIST_ML_MIN_ALPHA = 0.01
# sqrt(2π) as the f32 graph computes it: the f32 square root of f32(2π)
_SQRT_2PI = float(np.sqrt(np.float32(2.0 * math.pi)))


class VolumeConfig(NamedTuple):
    """Volume knobs (the reference renderer's volume properties)."""

    volume_spp: int = 1
    volume_phase_p: float = 0.3
    dist_guide_p: float = 0.0
    distance_mc_samples: int = 3
    distance_grid_width: int = 25  # pixels per distance-MC tile
    distance_state_count: int = 10
    volume_use_light_cache: bool = False
    particle_size_um: float = 25.0
    forward_project: bool = True

    @property
    def draine_g(self) -> float:
        return math.exp(-2.20679 / (self.particle_size_um + 3.91029) - 0.428934)

    @property
    def draine_a(self) -> float:
        return math.exp(3.62489 - 8.29288 / (self.particle_size_um + 5.52825))


class DistanceMC(NamedTuple):
    """Distance-MC states, [tiles, state_count]."""

    sum_w: torch.Tensor  # f32[C, K]
    N: torch.Tensor  # i32[C, K]
    moments: torch.Tensor  # f32[C, K, 2]


class VolumeState(NamedTuple):
    dist_mc: DistanceMC
    volume_depth: torch.Tensor  # f32[H, W] expected scatter distance
    prev_volume_depth: torch.Tensor  # f32[H, W]


def _tile_count(config: RenderConfig, vcfg: VolumeConfig) -> int:
    gx = config.width // vcfg.distance_grid_width + 2
    gy = config.height // vcfg.distance_grid_width + 2
    return gx * gy


def init_volume_state(config: RenderConfig, vcfg: VolumeConfig, device="cuda") -> VolumeState:
    c = _tile_count(config, vcfg)
    k = vcfg.distance_state_count
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return VolumeState(
        dist_mc=DistanceMC(
            sum_w=z(c, k), N=torch.zeros((c, k), dtype=torch.int32, device=device),
            moments=z(c, k, 2),
        ),
        volume_depth=z(config.height, config.width),
        prev_volume_depth=z(config.height, config.width),
    )


def _dist_tile_idx(rng, pxf, pyf, config, vcfg):
    """Stochastic-interpolated 2D tile index + random slot."""
    gw = float(vcfg.distance_grid_width)
    gx = config.width // vcfg.distance_grid_width + 2
    rng, u2 = rng_ops.uniform2(rng)
    # floor, then a conversion that truncates toward zero (as astype)
    ix = torch.floor(pxf / gw - 0.5 + u2[:, 0]).to(torch.int32) + 1
    iy = torch.floor(pyf / gw - 0.5 + u2[:, 1]).to(torch.int32) + 1
    tile = (
        torch.clamp(iy, 0, config.height // vcfg.distance_grid_width + 1) * gx
        + torch.clamp(ix, 0, gx - 1)
    )
    rng, u = rng_ops.uniform(rng)
    slot = torch.clamp_max(
        (u * vcfg.distance_state_count).to(torch.int32), vcfg.distance_state_count - 1
    )
    return rng, tile, slot


def _normal_dist(sum_w, n, moments):
    """(mu, sigma) with the N-prior regularizer."""
    m = moments / torch.where(sum_w > 0.0, sum_w, 1.0)[..., None]
    sigma = torch.sqrt(torch.clamp_min(m[..., 1] - torch.square(m[..., 0]), 0.0))
    n2 = (n * n).to(torch.float32)
    sigma = (n2 * sigma + 0.2) / (n2 + 0.2)
    return m[..., 0], sigma


def _normal_pdf(mu, sigma, t):
    s = torch.clamp_min(sigma, 1e-4)
    return torch.exp(-0.5 * torch.square((t - mu) / s)) / (s * _SQRT_2PI)


def render_volume(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    mcfg: MCPGConfig,
    vcfg: VolumeConfig,
    mstate: MCPGState,
    vstate: VolumeState,
    gbuf: GBufferOutput,
    schedule=None,
    packed=None,
    y0=0,
    rows: int | None = None,
    gather_img_fn=lambda x: x,
):
    """One volume pass over image rows [y0, y0 + rows) (default: the
    whole image). Returns (volume img [rows,W,4], volume mv [rows,W,2],
    new VolumeState, SurfaceResult whose queues feed the replay, with the
    distance-MC writes in ``.dist``). The volume motion vectors are the
    forward-projected previous scatter depth. ``packed``: the frame's
    tables from ``surface.pack_tables``, shared with the surface pass;
    built here otherwise. ``gather_img_fn``: (rows, W[, C]) slab → full
    (H, W[, C]) image (post.sharded.ShardCtx.gather_rows; identity on
    one device): the forward projection scatters into any pixel, so it
    runs on the whole image and keeps the slab's rows."""
    W, H = config.width, config.height
    rows = H if rows is None else rows
    n = W * rows
    K = mcfg.mc_samples
    DK = vcfg.distance_mc_samples
    cam_x = uniforms.cam_x
    dev = gbuf.linear_z.device

    pxi, pyi = layout.gen_pixels(W, rows, y0=y0, device=dev)
    pxf = pxi.to(torch.float32)
    pyf = pyi.to(torch.float32)
    rng = rng_ops.seed_pixel(pxi, pyi, uniforms.frame, config.seed + 101)

    linear_z = layout.image_to_flat(gbuf.linear_z, W, rows)
    first_wi = cam_ops.ray_dir(pxf, pyf, W, H, uniforms.cam_u, uniforms.cam_w, uniforms.fov_tan_half)

    vol_mv = _forward_project(
        gather_img_fn(gbuf.mv), gather_img_fn(vstate.prev_volume_depth), uniforms, config
    )[y0 : y0 + rows]
    mv_flat = layout.image_to_flat(vol_mv, W, rows)

    dmc = vstate.dist_mc
    max_t_pix = torch.minimum(linear_z, uniforms.volume_max_t)
    mc_packed, lc_packed = packed if packed is not None else pack_tables(mstate, uniforms)

    irr_acc = torch.zeros((n, 3), device=dev)
    m2_acc = torch.zeros((n,), device=dev)
    lcq_all, upq_all, zq_all, dq_all = [], [], [], []
    expected_depth = linear_z
    ka_exact = K * mcfg.mc_samples_adaptive_prob
    cam_shift = linalg.dot(cam_x - uniforms.prev_cam_x, first_wi)

    for s in range(vcfg.volume_spp):
        # ---- camera-distance sampling ----
        xi_max = trans_ops.xi_max(uniforms.mu_t, max_t_pix)
        score_sum_d = torch.zeros((n,), device=dev)
        t_sel = torch.zeros((n,), device=dev)
        win_sw = torch.zeros((n,), device=dev)
        win_n = torch.zeros((n,), dtype=torch.int32, device=dev)
        win_mm = torch.zeros((n, 2), device=dev)
        mus, sigmas, dscores = [], [], []
        for _ in range(DK):
            if s == 0:
                lpx = torch.clamp(pxf + mv_flat[:, 0], 0.0, W - 1.0)
                lpy = torch.clamp(pyf + mv_flat[:, 1], 0.0, H - 1.0)
            else:
                lpx, lpy = pxf, pyf
            rng, tile, slot = _dist_tile_idx(rng, lpx, lpy, config, vcfg)
            tile, slot = tile.to(torch.int64), slot.to(torch.int64)
            sw = dmc.sum_w[tile, slot]
            nn = dmc.N[tile, slot]
            mm = dmc.moments[tile, slot]
            mu_i, sg_i = _normal_dist(sw, nn, mm)
            if s == 0:
                # camera-velocity corrected
                mu_i = mu_i - cam_shift
            sc = sw * (sw > 0.0) * (mu_i < linear_z)
            score_sum_d = score_sum_d + sc
            rng, u = rng_ops.uniform(rng)
            take = u < sc / score_sum_d  # NaN false
            rng, u2 = rng_ops.uniform2(rng)
            # Box-Muller normal sample
            r0 = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u2[:, 0], 1e-12)))
            t_norm = mu_i + sg_i * r0 * torch.cos(2.0 * math.pi * u2[:, 1])
            t_sel = torch.where(take, t_norm, t_sel)
            win_sw = torch.where(take, sw, win_sw)
            win_n = torch.where(take, nn, win_n)
            win_mm = torch.where(take[..., None], mm, win_mm)
            mus.append(mu_i)
            sigmas.append(sg_i)
            dscores.append(sc)

        rng, u_g = rng_ops.uniform(rng)
        use_trans = (u_g >= vcfg.dist_guide_p) | (score_sum_d == 0.0)
        rng, u_t = rng_ops.uniform(rng)
        t_trans = trans_ops.sample(u_t * xi_max, uniforms.mu_t, max_t_pix)
        t = torch.where(use_trans, t_trans, t_sel)
        bad_guided = (~use_trans) & ((t >= max_t_pix) | (t <= 0.0))
        sample_ok = ~bad_guided & (xi_max > 0.0)

        p_dist = torch.zeros((n,), device=dev)
        for mu_i, sg_i, sc in zip(mus, sigmas, dscores):
            p_dist = p_dist + sc * _normal_pdf(mu_i, sg_i, t)
        has_d = score_sum_d > 0.0
        p_dist = torch.where(has_d, p_dist / torch.where(has_d, score_sum_d, 1.0), 0.0)
        p = (
            torch.where(has_d, 1.0 - vcfg.dist_guide_p, 1.0)
            * trans_ops.pdf(t, uniforms.mu_t, max_t_pix)
            + vcfg.dist_guide_p * p_dist
        )

        pos = cam_x + t[..., None] * first_wi
        vnormal = -first_wi

        # ---- guided direction sampling (same MC grids; the stratified
        # grid choice of the surface pass) ----
        score_sum = torch.zeros((n,), device=dev)
        gmus, gkaps, gscores, gns = [], [], [], []
        rng, win = grids.new_state(rng)
        win_buf = torch.full((n,), -1, dtype=torch.int64, device=dev)
        vol_level = grids.adaptive_target_level(pos, cam_x, mcfg)
        for k in range(K):
            if k + 1 <= int(ka_exact):
                mode = "adaptive"
            elif k >= math.ceil(ka_exact):
                mode = "static"
            else:
                mode = "mixed"
            if mode != "static":
                rng, abuf, ahash = grids.adaptive_cell(
                    rng, pos, vnormal, cam_x, mcfg, target_level=vol_level
                )
            if mode != "adaptive":
                rng, sbuf, shash = grids.static_cell(rng, pos, mcfg)
            if mode == "adaptive":
                buf = abuf
            elif mode == "static":
                buf = sbuf
            else:
                rng, u_grid = rng_ops.uniform(rng)
                adaptive = u_grid < (ka_exact - int(ka_exact))
                buf = torch.where(adaptive, abuf, sbuf)
            st = grids.gather_state_packed_draw(mc_packed, buf)
            if mode == "adaptive":
                st = grids.finalize_load(st, ahash, uniforms.cl_time)
            elif mode == "static":
                st = grids.finalize_load(st, shash, uniforms.cl_time)
            else:
                st = _select_state(
                    adaptive,
                    grids.finalize_load(st, ahash, uniforms.cl_time),
                    grids.finalize_load(st, shash, uniforms.cl_time),
                )
            score_sum = score_sum + st.sum_w
            rng, u_res = rng_ops.uniform(rng)
            take = u_res < st.sum_w / score_sum
            win = _select_state(take, st, win)
            win_buf = torch.where(take, buf, win_buf)
            mu_g, kap_g = grids.state_vmf(st, pos, mcfg)
            gmus.append(mu_g)
            gkaps.append(kap_g)
            gscores.append(st.sum_w)
            gns.append(st.N)

        have_guide = score_sum > 0.0

        # per-draw defensive PHASE probability, mirroring the surface
        # pass's maturity gate: immature chains sample the Draine phase
        # like the unguided estimator; the MIS pdf mixes the per-draw
        # probabilities, the exact marginal density
        def _vpp_of(n_arr):
            if mcfg.surf_bsdf_trust_n <= 0:
                return torch.full(tuple(n_arr.shape), vcfg.volume_phase_p, device=dev)
            nf = n_arr.to(torch.float32)
            mat = nf / (nf + float(mcfg.surf_bsdf_trust_n))
            return 1.0 - (1.0 - vcfg.volume_phase_p) * mat

        rng, u_p = rng_ops.uniform(rng)
        use_phase = (~have_guide) | (u_p < _vpp_of(win.N))
        rng, u_ph = rng_ops.uniform(rng)
        cos_t = phase_ops.draine_sample_cos(u_ph, vcfg.draine_g, vcfg.draine_a)
        rng, u_az = rng_ops.uniform(rng)
        wo_phase = phase_ops.sample_dir(first_wi, cos_t, u_az)
        win_mu, win_kap = grids.state_vmf(win, pos, mcfg)
        rng, u2 = rng_ops.uniform2(rng)
        wo_vmf = vmf.sample(win_mu, win_kap, u2)
        wo = torch.where(use_phase[..., None], wo_phase, wo_vmf)
        rng, fresh = grids.new_state(rng)
        mc_state = _select_state(use_phase, fresh, win)
        mc_idx = torch.where(use_phase, -1, win_buf)

        safe_sum = torch.where(have_guide, score_sum, 1.0)
        phase_mix = torch.zeros((n,), device=dev)
        guided_p = torch.zeros((n,), device=dev)
        for mu_g, kap_g, sc_g, n_g in zip(gmus, gkaps, gscores, gns):
            vpp_g = _vpp_of(n_g)
            w_g = sc_g / safe_sum
            phase_mix = phase_mix + w_g * vpp_g
            guided_p = guided_p + w_g * (1.0 - vpp_g) * vmf.pdf(wo, mu_g, kap_g)
        phase_pdf = phase_ops.draine_pdf(linalg.dot(first_wi, wo), vcfg.draine_g, vcfg.draine_a)
        wo_p = (
            torch.where(have_guide, phase_mix, 1.0) * phase_pdf
            + torch.where(have_guide, guided_p, 0.0)
        )
        p = p * wo_p

        # ---- trace from the scatter point ----
        res = trace_ray(
            accel, atlas, uniforms, pos, wo,
            bilinear=config.bilinear, features=config.features,
            sort_rays=sorts_bounce_rays(schedule), schedule=schedule,
        )
        incident = res.contribution
        if vcfg.volume_use_light_cache:
            rng, lc_irr = lc_get(
                rng, mstate.lc, res.hit.pos, res.hit.normal, cam_x, mcfg, packed=lc_packed,
            )
            no_inc = ~(incident > 0.0).any(-1)
            incident = torch.where(no_inc[..., None], res.throughput * lc_irr, incident)

        contrib = (
            incident
            * phase_pdf[..., None]
            * uniforms.mu_s
            * trans_ops.transmittance(t, uniforms.mu_t, uniforms.volume_max_t)[..., None]
            / torch.clamp_min(p, 1e-30)[..., None]
        )
        ok = sample_ok & torch.isfinite(contrib).all(-1)
        contrib = torch.where(ok[..., None], contrib, 0.0)
        irr_acc = irr_acc + contrib
        lum = color_ops.yuv_luminance(contrib)
        m2_acc = m2_acc + lum * lum

        # ---- distance MC update ----
        nw = torch.clamp_max(win_n + 1, DIST_ML_MAX_N)
        al = torch.clamp_min(1.0 / torch.clamp_min(nw, 1), DIST_ML_MIN_ALPHA)
        new_sw = win_sw + (lum - win_sw) * al
        new_mm = win_mm + (lum[..., None] * torch.stack([t, t * t], -1) - win_mm) * al[..., None]
        if s == vcfg.volume_spp - 1:
            exp_d = torch.where(
                new_sw > 0.0, new_mm[..., 0] / torch.clamp_min(new_sw, 1e-20), linear_z
            )
            expected_depth = torch.where(ok, exp_d, linear_z)
        rng, u_save = rng_ops.uniform(rng)
        save = ok & (u_save < lum / (score_sum_d / DK))  # NaN false
        rng, tile_s, slot_s = _dist_tile_idx(rng, pxf, pyf, config, vcfg)
        C = dmc.sum_w.shape[0]
        # deferred write: queued for the replay
        dq_all.append(
            DistQueue.build(
                sw=new_sw, m0=new_mm[..., 0], m1=new_mm[..., 1], n_chain=nw,
                flat=tile_s * vcfg.distance_state_count + slot_s, mask=save,
                sentinel=C * vcfg.distance_state_count,
            )
        )

        # ---- direction MC update (jittered normal around -wi) ----
        mc_f = color_ops.yuv_luminance(
            phase_pdf[..., None] * incident / torch.clamp_min(wo_p, 1e-30)[..., None]
        )
        if mcfg.mc_update_clamp > 0.0:
            # luminance-clamped guiding updates; NaN stays NaN
            mc_f = torch.minimum(mc_f, linalg.as_f32(mcfg.mc_update_clamp, mc_f))
        rng, u_acc = rng_ops.uniform(rng)
        accept = ok & (u_acc < mc_f / (score_sum / K))  # NaN false
        rng, u_cos = rng_ops.uniform2(rng)
        jit_n = linalg.sample_cos(-first_wi, u_cos)
        rng, fb_buf, _ = grids.adaptive_cell(rng, pos, jit_n, cam_x, mcfg)
        up_cell = torch.where(mc_idx >= 0, mc_idx, fb_buf)
        missing = grids.light_missing(mc_state, mc_f, wo, pos, mcfg)
        zero_mask = ok & ~accept & (mc_idx >= 0) & missing
        if not mcfg.mc_fast_recovery:
            zero_mask = torch.zeros_like(zero_mask)
        upq_all.append(
            UpdateQueue.build(
                cell=up_cell,
                id=mc_state.id,
                w=mc_f,
                target=res.hit.pos,
                mv=(res.hit.pos - res.hit.prev_pos) / uniforms.time_diff,
                pos=pos,
                normal=jit_n,
                mask=accept & torch.isfinite(mc_f),
                sentinel=mcfg.mc_total_size,
            )
        )
        zq_all.append(ZeroQueue(cell=torch.clamp_min(mc_idx, 0).to(torch.int32), mask=zero_mask))
        lcq_all.append(
            LCQueue(
                pos=pos, normal=jit_n, irr=torch.zeros((n, 3), device=dev),
                mask=torch.zeros((n,), dtype=torch.bool, device=dev),
            )
        )

    spp = max(vcfg.volume_spp, 1)
    img = layout.flat_to_image(torch.cat([irr_acc / spp, (m2_acc / spp)[..., None]], dim=-1), W, rows)
    cat = lambda parts, cls: cls(*[torch.cat(xs) for xs in zip(*parts)])
    extra = SurfaceResult(
        irradiance=img,
        updates=cat(upq_all, UpdateQueue),
        lc_samples=cat(lcq_all, LCQueue),
        zeros=cat(zq_all, ZeroQueue),
        dist=cat(dq_all, DistQueue),
    )
    depth_img = layout.flat_to_image(expected_depth, W, rows)
    new_vstate = VolumeState(dist_mc=dmc, volume_depth=depth_img, prev_volume_depth=depth_img)
    return img, vol_mv, new_vstate, extra


DIST_QUEUE_CAPACITY = 1 << 18


def compact_dist(dq: DistQueue, total: int, gidx, n_shards: int = 1) -> torch.Tensor:
    """Class-sort + static live prefix of a DistQueue: the first
    ``DIST_QUEUE_CAPACITY / n_shards`` live rows in row order (a stable
    sort), each with its global row index ``gidx`` as a 6th column, so the
    replay's winner per slot is the max-gidx row whatever order the
    shards' rows are gathered in. ``total`` = number of (tile, slot)
    states. Returns i32[cap, 6]."""
    M = dq.data.shape[0]
    live = dq.data[:, 4] < total
    ps = torch.sort((~live).to(torch.int8), stable=True).indices
    cap = int(min(M, max(DIST_QUEUE_CAPACITY // n_shards, 256)))
    tab = torch.cat([dq.data, gidx.to(torch.int32)[:, None]], dim=1)
    return tab[ps[:cap]]


def apply_dist_updates(dmc: DistanceMC, data: torch.Tensor) -> DistanceMC:
    """Apply compacted DistQueue rows (``compact_dist``, i32[cap, 6]) to
    the distance-MC grid.

    Last writer wins among duplicate (tile, slot) rows: the max-gidx row,
    selected by one (flat, gidx) sort and the segment ends, so the slot
    scatters run at unique indices. Overflow past the compaction capacity
    drops rows.
    """
    total = dmc.sum_w.numel()
    flat_in = torch.where(data[:, 4] < total, data[:, 4], total)
    segs, (cols,) = segments.sort_segments(flat_in, [data[:, 0:4]], tiebreak=data[:, 5])
    keep = segs.is_end & (segs.cell < total)
    flat = torch.where(keep, segs.cell, total)
    sw = _i2f(cols[:, 0])
    mm = _i2f(cols[:, 1:3])
    nw = cols[:, 3]
    return DistanceMC(
        sum_w=segments.scatter_rows(dmc.sum_w.reshape(-1), flat, sw).reshape(dmc.sum_w.shape),
        N=segments.scatter_rows(dmc.N.reshape(-1), flat, nw).reshape(dmc.N.shape),
        moments=segments.scatter_rows(dmc.moments.reshape(-1, 2), flat, mm).reshape(
            dmc.moments.shape
        ),
    )


def _forward_project(surface_mv, prev_volume_depth, uniforms: Uniforms, config):
    """Scatter the previous frame's volume depth into this frame's pixels
    to produce volume motion vectors (the surface MVs where no projection
    lands). Where several source pixels land on one target, the last in
    row order writes, as the JAX package's scatter applies its rows on
    the CPU; the rule is resolved before the scatter, so any device gives
    the same image."""
    H, W = prev_volume_depth.shape
    dev = prev_volume_depth.device
    pxi, pyi = layout.gen_pixels(W, H, device=dev)
    px = pxi.to(torch.float32)
    py = pyi.to(torch.float32)
    prev_wi = cam_ops.ray_dir(
        px, py, W, H, uniforms.prev_cam_u, uniforms.prev_cam_w, uniforms.fov_tan_half
    )
    prev_flat = layout.image_to_flat(prev_volume_depth, W, H)
    prev_pos = uniforms.prev_cam_x + prev_wi * prev_flat[:, None]
    npx, npy, dz = cam_ops.project(
        prev_pos - uniforms.cam_x, W, H, uniforms.cam_u, uniforms.cam_w, uniforms.fov_tan_half
    )
    # round half to even (as jnp.round); the bounds test runs on the
    # floats, which the int32 conversion of the JAX package then agrees with
    rx, ry = torch.round(npx), torch.round(npy)
    ok = (rx >= 0) & (rx < W) & (ry >= 0) & (ry < H) & (prev_flat >= 50.0) & (dz > 0)
    nx = torch.where(ok, rx, 0.0).to(torch.int64)
    ny = torch.where(ok, ry, 0.0).to(torch.int64)
    flat_new = torch.where(ok, layout.index_of(nx, ny, W, H), H * W)
    # duplicate targets: the last source row writes
    iota = torch.arange(H * W, dtype=torch.int64, device=dev)
    last = torch.full((H * W + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, flat_new, iota, "amax"
    )
    flat_new = torch.where(last[flat_new] == iota, flat_new, H * W)
    out = layout.image_to_flat(surface_mv, W, H)
    out = segments.scatter_rows(out, flat_new, torch.stack([px - npx, py - npy], -1))
    return layout.flat_to_image(out, W, H)
