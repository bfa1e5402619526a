"""ReSTIR DI pass pipeline: generate → temporal → spatial → shade.

Port of merian_quake_tpu/render/restir/restir.py (the reference's
restir_di_{generate_samples_bsdf,temporal_reuse,spatial_reuse,shade}.comp
and renderer_restir.cpp:206-250). Defaults mirror
renderer_restir.hpp:106-128. The previous frame's reservoirs and
geometry live in ReSTIRState. On one device neighbour reads are gathers
from the frame's own buffers (``index_select``); on a row slab
(``shard_ctx``) they read a halo of the neighbouring slabs' rows when the
slab is tall enough for the reuse radius, else the gathered image.
"""
from __future__ import annotations

from typing import NamedTuple

import types

import torch

from ...accel.build import AccelScene
from ...accel.intersect import trace_visibility
from ...models.types import RenderConfig, TextureAtlas, Uniforms
from ...ops import bsdf, color as color_ops, linalg, rng as rng_ops
from .. import layout
from ..gbuffer import GBufferOutput
from ..hit import Hit, decompress_hit
from ..trace import trace_ray
from . import reservoir as rsv
from .reservoir import Reservoir


class ReSTIRConfig(NamedTuple):
    """Static knobs (≈ spec constants, renderer_restir.hpp:106-128)."""

    spp: int = 1
    apply_mv: bool = False
    spatial_reuse_iterations: int = 1
    temporal_clamp_m: int = 32 * 20
    boiling_filter_strength: float = 0.0
    temporal_normal_reject_cos: float = 0.96
    temporal_depth_reject: float = 0.1
    spatial_normal_reject_cos: float = 0.96
    spatial_depth_reject: float = 0.1
    spatial_radius: float = 30.0
    temporal_bias_correction: int = 0  # 0 none, 1 basic, 2 raytraced
    spatial_bias_correction: int = 0
    visibility_shade: bool = True


class ReSTIRState(NamedTuple):
    """Delayed (prev-frame) graph inputs."""

    reservoirs: Reservoir  # finalized reservoirs of the previous frame
    prev_normal: torch.Tensor  # f32[N, 3]
    prev_linear_z: torch.Tensor  # f32[N]


def init_restir_state(width: int, height: int, device="cuda") -> ReSTIRState:
    n = width * height
    return ReSTIRState(
        reservoirs=rsv.reservoir_init(n, device),
        prev_normal=torch.zeros((n, 3), device=device),
        prev_linear_z=torch.full((n,), 1e30, device=device),
    )


def target_pdf(y_pos, y_normal, y_radiance, surf: Hit):
    """restir_di_target_pdf (restir_di_common.glsl:7-18)."""
    d = y_pos - surf.pos
    dist2 = torch.clamp_min((d * d).sum(-1), 1e-12)
    wo = d / torch.sqrt(dist2)[..., None]
    wodotn = linalg.dot(wo, surf.normal)
    alpha = bsdf.roughness_to_alpha(surf.roughness)
    f = bsdf.eval_times_cos(surf.wi, wo, surf.normal, alpha)
    geo = torch.clamp_min(linalg.dot(y_normal, -wo), 0.0) / dist2
    p = geo * f * color_ops.yuv_luminance(y_radiance)
    return torch.where(wodotn > 0.0, p, 0.0)


def _reproj_valid(n_a, n_b, cos_thresh, z_a, vel_z, z_b, reject):
    """merian-shaders/reprojection.glsl-style validity gate."""
    n_ok = linalg.dot(n_a, n_b) >= cos_thresh
    z_ok = (z_b - (z_a + vel_z)).abs() <= reject * torch.clamp_min(
        torch.maximum(z_a, z_b), 1e-3
    )
    return n_ok & z_ok


def _seed(px, py, frame, pass_idx, seed):
    """Per-pass stream seed: the frame index is frame·4 + pass (u32)."""
    return rng_ops.seed_pixel(px, py, (frame * 4 + pass_idx) & 0xFFFFFFFF, seed)


def _boiling_mask(w, w_full, W, H, y0, rows, strength):
    """Reservoirs ``w`` (the slab's) whose W exceeds their 8×8 tile's mean
    over positive weights by the strength's factor
    (restir_di_temporal_reuse.comp:39-70; the reference's subgroup is its
    8×8 workgroup). The tiles align to image row 0, so the means come from
    the whole image's weights ``w_full``. Rows and columns past the last
    whole tile use the nearest tile's mean."""
    mult = 10.0 / strength - 9.0
    wimg = layout.flat_to_image(w_full, W, H)
    th, tw = H // 8, W // 8
    tiles = wimg[: th * 8, : tw * 8].reshape(th, 8, tw, 8)
    cnt = (tiles > 0).sum((1, 3)).float()
    mean = tiles.sum((1, 3)) / torch.clamp_min(cnt, 1.0)
    mean_full = mean.repeat_interleave(8, 0).repeat_interleave(8, 1)
    if H > th * 8:
        mean_full = torch.cat([mean_full, mean_full[-1:].expand(H - th * 8, -1)], 0)
    if W > tw * 8:
        mean_full = torch.cat([mean_full, mean_full[:, -1:].expand(-1, W - tw * 8)], 1)
    return w > layout.image_to_flat(mean_full[y0 : y0 + rows], W, rows) * mult


def _halo_reader(shard_ctx, cols, W, rows, r_halo):
    """Reads of ``cols`` (the slab's flat columns) at image pixels within
    ``r_halo`` rows of the slab: the columns travel as one f64 table
    (every value an f32, a u32 in int64, an i32 or a bool, so exactly),
    halo-padded with the neighbouring slabs' rows. Returns read(px, py)
    → (columns at those pixels, whether each lies in the padded slab)."""
    metas = [(c.dtype, c.dim(), 1 if c.dim() == 1 else c.shape[1]) for c in cols]
    tab = torch.cat([(c[:, None] if c.dim() == 1 else c).to(torch.float64) for c in cols], 1)
    pad = shard_ctx.halo_pad(layout.flat_to_image(tab, W, rows), r_halo)
    span = rows + 2 * r_halo

    def read(px_t, py_t):
        ly = py_t - (shard_ctx.y0 - r_halo)
        ok = (ly >= 0) & (ly < span)
        v = pad[ly.clamp(0, span - 1).long(), px_t.long()]
        outs, o = [], 0
        for dt, nd, k in metas:
            x = v[:, o : o + k].to(dt)
            o += k
            outs.append(x[:, 0] if nd == 1 else x)
        return outs, ok

    return read


def render_restir(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    rcfg: ReSTIRConfig,
    rstate: ReSTIRState,
    gbuf: GBufferOutput,
    schedule=None,
    y0=0,
    rows: int | None = None,
    shard_ctx=None,
    force_gather: bool = False,
):
    """ReSTIR DI over image rows [y0, y0 + rows) (default: the whole
    frame). Returns (irradiance f32[rows, W, 4], the new ReSTIRState of
    the slab). ``schedule``: the card's trace schedule
    (accel.woop.TraceSchedule), for every trace and visibility sweep.

    On a row slab (``shard_ctx``, post.sharded.ShardCtx) the cross-pixel
    reads (the previous frame's reservoirs and geometry at the motion
    vector's target, the post-temporal reservoirs and geometry of the
    spatial neighbours, the boiling filter's tile means) come from a halo
    of ``max(spatial_radius + 1, 16)`` rows of the neighbouring slabs
    when the slab is that tall, else (or with ``force_gather``, the JAX
    package's ``FORCE_GATHER``) from the gathered image. A target beyond
    the halo rejects reuse, which only a motion of more than the halo's
    rows a frame reaches."""
    W, H = config.width, config.height
    rows = H if rows is None else rows
    n = W * rows
    dev = accel.woop_w.device
    pxf, pyf = layout.gen_pixels(W, rows, y0=y0, device=dev)
    tex = atlas if config.features.has_alpha_tris else None
    gf = (lambda x: x) if shard_ctx is None else (lambda x: shard_ctx.gather_flat(x, W))
    r_halo = int(max(rcfg.spatial_radius + 1, 16))
    use_halo = shard_ctx is not None and not force_gather and rows < H and r_halo <= rows

    surf = decompress_hit(gbuf.hits)
    pixel_live = (surf.albedo >= 1e-7).any(-1)
    normal = layout.image_to_flat(gbuf.normal, W, rows)
    linear_z = layout.image_to_flat(gbuf.linear_z, W, rows)
    vel_z = layout.image_to_flat(gbuf.z_vel, W, rows)
    surf_cols = [surf.pos, surf.normal, surf.wi, surf.roughness]
    alpha = bsdf.roughness_to_alpha(surf.roughness)

    # ---------- pass 1: generate (BSDF candidates) ----------
    rng = _seed(pxf, pyf, uniforms.frame, 0, config.seed)
    r = rsv.reservoir_init(n, dev)
    for _ in range(rcfg.spp):
        rng, u3 = rng_ops.uniform3(rng)
        wo = bsdf.sample(surf.wi, surf.normal, alpha, u3)
        wodotn = linalg.dot(wo, surf.normal)
        ok = pixel_live & (wodotn > 1e-3) & (linalg.dot(wo, surf.geo_normal) > 1e-3)
        origin = surf.pos - surf.wi * 1e-3
        res = trace_ray(
            accel, atlas, uniforms, origin, wo,
            bilinear=config.bilinear, features=config.features, schedule=schedule,
        )
        nh = res.hit
        d2 = torch.clamp_min(torch.square(nh.pos - surf.pos).sum(-1), 1e-12)
        geo = torch.clamp_min(linalg.dot(nh.normal, -wo), 0.0) / d2
        p_sample = geo * bsdf.pdf(surf.wi, wo, surf.normal, alpha)
        p_tgt = target_pdf(nh.pos, nh.normal, res.contribution, surf)
        rng, r, _ = rsv.add_sample(
            r, rng, ok & (p_sample > 0.0), nh.pos, nh.normal,
            (nh.pos - nh.prev_pos) / uniforms.time_diff,
            uniforms.cl_time.expand(n), res.contribution,
            torch.full((n,), rsv.FLAG_VALID, dtype=torch.int64, device=dev),
            p_sample, p_tgt,
        )
    r = rsv.finalize(r)

    # ---------- pass 2: temporal reuse ----------
    rng = _seed(pxf, pyf, uniforms.frame, 1, config.seed)
    cur = r
    r = rsv.reservoir_init(n, dev)
    rng, r, _ = rsv.combine_finalized(r, rng, cur, cur.p_target)

    mv = layout.image_to_flat(gbuf.mv, W, rows)
    ppx = torch.round(pxf.float() + mv[:, 0]).to(torch.int32)
    ppy = torch.round(pyf.float() + mv[:, 1]).to(torch.int32)
    inb = (ppx >= 0) & (ppx < W) & (ppy >= 0) & (ppy < H)
    if use_halo:
        read_t = _halo_reader(
            shard_ctx,
            [*rstate.reservoirs, rstate.prev_normal, rstate.prev_linear_z, *surf_cols],
            W, rows, r_halo,
        )
        tvals, ok_h = read_t(ppx.clamp(0, W - 1), ppy.clamp(0, H - 1))
        prev = Reservoir(*tvals[:9])
        prev_n, prev_z = tvals[9], tvals[10]
        prev_surf = types.SimpleNamespace(
            pos=tvals[11], normal=tvals[12], wi=tvals[13], roughness=tvals[14]
        )
        inb = inb & ok_h
    else:
        pidx = layout.index_of(ppx.clamp(0, W - 1), ppy.clamp(0, H - 1), W, H).long()
        prev_n = gf(rstate.prev_normal).index_select(0, pidx)
        prev_z = gf(rstate.prev_linear_z).index_select(0, pidx)
        prev = Reservoir(*[gf(x).index_select(0, pidx) for x in rstate.reservoirs])
        prev_surf = None
    tvalid = (
        inb
        # a device test, so a captured frame reads each replay's number
        & (rng_ops._u32(uniforms.frame, inb) > 0)
        & _reproj_valid(
            normal, prev_n, rcfg.temporal_normal_reject_cos,
            linear_z, vel_z, prev_z, rcfg.temporal_depth_reject,
        )
    )
    if rcfg.apply_mv:
        dt = (uniforms.cl_time - prev.y_T)[..., None]
        prev = prev._replace(
            y_pos=prev.y_pos + prev.y_mv * dt, y_T=uniforms.cl_time.expand(n)
        )
    if rcfg.temporal_clamp_m > 0:
        prev = prev._replace(M=torch.clamp_max(prev.M, rcfg.temporal_clamp_m))
    p_tgt_prev = target_pdf(prev.y_pos, prev.y_normal, prev.y_radiance, surf)
    rng, combined, sel_prev = rsv.combine_finalized(r, rng, prev, p_tgt_prev, mask=tvalid)
    # lanes that early-return in the reference keep the current-only
    # reservoir (finalized below with M from `cur` only)
    if rcfg.temporal_bias_correction == 0:
        r = rsv.finalize(combined)
    else:
        pi = combined.p_target
        pi_sum = combined.p_target * cur.M.float()
        if prev_surf is None:
            prev_surf = Hit(*[gf(x).index_select(0, pidx) for x in surf])
        temporal_p = target_pdf(
            combined.y_pos, combined.y_normal, combined.y_radiance, prev_surf
        )
        if rcfg.temporal_bias_correction == 2:
            vis = trace_visibility(accel, tex, surf.pos, combined.y_pos, schedule=schedule)
            temporal_p = torch.where(vis, temporal_p, 0.0)
        temporal_p = torch.where(tvalid, temporal_p, 0.0)
        pi = torch.where(sel_prev, temporal_p, pi)
        pi_sum = pi_sum + temporal_p * prev.M.float()
        r = rsv.finalize_custom(combined, pi, pi_sum)

    if rcfg.boiling_filter_strength > 1e-6:
        r = rsv.discard(
            r, _boiling_mask(r.w, gf(r.w), W, H, y0, rows, rcfg.boiling_filter_strength)
        )

    # ---------- pass 3: spatial reuse ----------
    rng = _seed(pxf, pyf, uniforms.frame, 2, config.seed)
    spatial_in = r
    if use_halo:
        read_s = _halo_reader(
            shard_ctx, [*spatial_in, normal, linear_z, *surf_cols], W, rows, r_halo
        )
    else:
        sp_full = Reservoir(*[gf(x) for x in spatial_in])
        normal_full, z_full = gf(normal), gf(linear_z)
        surf_full = None
    r = rsv.reservoir_init(n, dev)
    rng, r, _ = rsv.combine_finalized(r, rng, spatial_in, spatial_in.p_target)
    neighbors = []
    sel_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for i in range(rcfg.spatial_reuse_iterations):
        rng, u2 = rng_ops.uniform2(rng)
        nx = torch.round(
            pxf.float() + rcfg.spatial_radius * (2 * u2[:, 0] - 1)
        ).to(torch.int32)
        ny = torch.round(
            pyf.float() + rcfg.spatial_radius * (2 * u2[:, 1] - 1)
        ).to(torch.int32)
        inb_s = (nx >= 0) & (nx < W) & (ny >= 0) & (ny < H)
        nx_c, ny_c = nx.clamp(0, W - 1), ny.clamp(0, H - 1)
        if use_halo:
            svals, ok_s = read_s(nx_c, ny_c)
            nb = Reservoir(*svals[:9])
            nb_normal, nb_z = svals[9], svals[10]
            nb_surf = types.SimpleNamespace(
                pos=svals[11], normal=svals[12], wi=svals[13], roughness=svals[14]
            )
            inb_s = inb_s & ok_s
        else:
            nidx = layout.index_of(nx_c, ny_c, W, H).long()
            nb = Reservoir(*[x.index_select(0, nidx) for x in sp_full])
            nb_normal = normal_full.index_select(0, nidx)
            nb_z = z_full.index_select(0, nidx)
            nb_surf = nidx
        nvalid = inb_s & _reproj_valid(
            normal, nb_normal, rcfg.spatial_normal_reject_cos,
            linear_z, vel_z, nb_z, rcfg.spatial_depth_reject,
        )
        p_tgt_nb = target_pdf(nb.y_pos, nb.y_normal, nb.y_radiance, surf)
        rng, r, took = rsv.combine_finalized(r, rng, nb, p_tgt_nb, mask=nvalid)
        sel_idx = torch.where(took, i, sel_idx)
        neighbors.append((nb_surf, nvalid, nb.M))
    if rcfg.spatial_bias_correction == 0 or rcfg.spatial_reuse_iterations == 0:
        r = rsv.finalize(r)
    else:
        pi = r.p_target
        pi_sum = r.p_target * spatial_in.M.float()
        for i, (nb_surf, nvalid, nb_m) in enumerate(neighbors):
            if not use_halo:
                # the neighbour's first hit, read at its flat index
                surf_full = Hit(*[gf(x) for x in surf]) if surf_full is None else surf_full
                nb_surf = Hit(*[x.index_select(0, nb_surf) for x in surf_full])
            sp = target_pdf(r.y_pos, r.y_normal, r.y_radiance, nb_surf)
            if rcfg.spatial_bias_correction == 2:
                vis = trace_visibility(accel, tex, nb_surf.pos, r.y_pos, schedule=schedule)
                sp = torch.where(vis, sp, 0.0)
            sp = torch.where(nvalid, sp, 0.0)
            pi = torch.where(sel_idx == i, sp, pi)
            pi_sum = pi_sum + sp * nb_m.float()
        r = rsv.finalize_custom(r, pi, pi_sum)

    # ---------- pass 4: shade ----------
    yvalid = rsv.valid(r) & pixel_live
    d = r.y_pos - surf.pos
    dist_y = torch.sqrt(torch.clamp_min((d * d).sum(-1), 1e-12))
    wo = d / dist_y[..., None]
    if rcfg.visibility_shade:
        # the reference's shade-time shadow ray (restir_di.comp), an
        # occlusion-only sweep (K2) on the card
        vis = trace_visibility(accel, tex, surf.pos, r.y_pos, schedule=schedule)
        occluded = yvalid & ~vis
        r = rsv.discard(r, occluded)
        yvalid = yvalid & ~occluded
    micro = bsdf.eval_times_cos(surf.wi, wo, surf.normal, alpha)
    w_ok = torch.isfinite(r.w)
    cos_y = torch.clamp_min(linalg.dot(r.y_normal, -wo), 0.0) / torch.square(dist_y)
    irr = torch.where(
        (yvalid & w_ok)[..., None],
        micro[..., None] * r.y_radiance * r.w[..., None] * cos_y[..., None],
        0.0,
    )
    lum = color_ops.yuv_luminance(irr)
    img = layout.flat_to_image(torch.cat([irr, (lum * lum)[..., None]], -1), W, rows)
    new_state = ReSTIRState(reservoirs=r, prev_normal=normal, prev_linear_z=linear_z)
    return img, new_state
