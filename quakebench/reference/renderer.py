"""The frame of the reference: a frozen copy of ``frame_core`` (with
``init_state`` and the MCPG pass ``_render_mcpg``) from the port's
``renderer.py``, whose trace goes to this package's plain accel
(``accel/intersect.py``) in place of the hand-written kernels. The
benchmark runs it once a run, after the timed window, to judge the
frame that the program's compiled frame produced (quakebench/check.py).
Only the imports and the compiled-frame entry points, which the
reference does not need, differ from the port's module.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .accel.build import AccelScene
from .models.types import RenderConfig, TextureAtlas, Uniforms
from .ops import color as color_ops
from .post.accumulate import accumulate, accumulate_reprojected
from .post.svgf import init_svgf_state
from .post.tonemap import tonemap_reinhard_extended
from .render.gbuffer import render_gbuffer
from .render.pt import render_pt

_INTEGRATORS = ("pt", "restir", "mcpg", "ssmm")


class FrameState(NamedTuple):
    """State threaded across frames (the accumulation histories)."""

    accum_irradiance: torch.Tensor  # f32[H, W, 4] path irradiance
    accum_direct: torch.Tensor  # f32[H, W, 4] first-hit emission
    accum_albedo: torch.Tensor  # f32[H, W, 4]
    # i32[] frames accumulated, a device scalar as in the JAX package, so
    # that a captured frame reads and advances it on the device (a Python
    # int is still taken by frame_core, which then returns one)
    iteration: torch.Tensor
    restir: object = None  # ReSTIRState when integrator == "restir"
    mcpg: object = None  # MCPGState when integrator == "mcpg"
    volume: object = None  # VolumeState when MCPGConfig.volume is set
    accum_volume: object = None  # f32[H, W, 4] accumulated volume radiance
    accum_volume_len: object = None  # f32[H, W] volume accum history length
    ssmm: object = None  # SSMMState when integrator == "ssmm"
    svgf: object = None  # SVGFState when config.denoise
    taa_prev: object = None  # f32[H, W, 3] previous LDR (TAA history)
    volume_svgf: object = None  # SVGFState for the volume denoiser


def _check_supported(config: RenderConfig) -> None:
    if config.integrator not in _INTEGRATORS:
        raise ValueError(f"unknown integrator {config.integrator!r}")


def init_state(config: RenderConfig, mcpg_config=None, device="cuda") -> FrameState:
    _check_supported(config)
    H, W = config.height, config.width
    z = lambda: torch.zeros((H, W, 4), device=device)
    restir = mcpg = volume = accum_volume = accum_volume_len = ssmm = None
    svgf = taa_prev = volume_svgf = None
    if config.integrator == "restir":
        from .render.restir import init_restir_state

        restir = init_restir_state(W, H, device=device)
    elif config.integrator == "mcpg":
        from .render.mcpg import MCPGConfig, init_mcpg_state

        mcfg = mcpg_config or MCPGConfig()
        mcpg = init_mcpg_state(mcfg, device=device)
        if mcfg.volume is not None:
            from .render.mcpg.volume import init_volume_state

            volume = init_volume_state(config, mcfg.volume, device=device)
            accum_volume = z()
            accum_volume_len = torch.zeros((H, W), device=device)
            if config.denoise:
                volume_svgf = init_svgf_state(H, W, device=device)
    elif config.integrator == "ssmm":
        from .render.ssmm import init_ssmm_state

        ssmm = init_ssmm_state(W, H, device=device)
    if config.denoise:
        svgf = init_svgf_state(H, W, device=device)
        taa_prev = torch.zeros((H, W, 3), device=device)
    return FrameState(
        accum_irradiance=z(), accum_direct=z(), accum_albedo=z(),
        iteration=torch.zeros((), dtype=torch.int32, device=device),
        restir=restir, mcpg=mcpg, volume=volume, accum_volume=accum_volume,
        accum_volume_len=accum_volume_len, ssmm=ssmm, svgf=svgf, taa_prev=taa_prev,
        volume_svgf=volume_svgf,
    )


def _render_mcpg(accel, atlas, uniforms, config, mcfg, mstate, vstate, gbuf, schedule):
    """The guided surface pass on MCPGState ``mstate``, the volume pass on
    VolumeState ``vstate`` when ``mcfg.volume`` is set, and the replay of
    their queues into the guiding state. Returns (irradiance image, new
    MCPGState, the volume's (new VolumeState, this frame's image, motion
    vectors) or None)."""
    from .render.mcpg.surface import (
        SurfaceResult, _seg_budgets, pack_tables, render_mcpg_surface,
    )
    from .render.mcpg.updates import apply_updates_compact, compact_queues, queue_gidx

    # both passes read the same packed tables: build them once
    packed = pack_tables(mstate, uniforms)
    res = render_mcpg_surface(
        accel, atlas, uniforms, config, mcfg, mstate, gbuf, schedule, packed=packed,
    )
    W, H = config.width, config.height
    spp = max(config.spp, 1)
    surf_groups = spp * max(config.max_path_length - 1, 1)
    dev = res.updates.data.device
    gidx = (
        res.gidx if res.gidx is not None
        else queue_gidx(res.updates.data.shape[0], surf_groups, W, H, device=dev)
    )
    # live-lane compaction makes each segment's queue rows past its
    # static budget DEAD padding (surface pads the compacted emissions
    # back to ns rows): slice them off here so that compact_queues sorts
    # Σbudgets rows instead of segments·ns. In overflow frames the
    # full-width fallback can emit beyond the budget; those rows drop —
    # render output stays exact, guiding just learns from fewer samples
    # that frame.
    segs_n = max(config.max_path_length - 1, 0)
    ns_q = W * H * spp
    buds = _seg_budgets(mcfg, segs_n, ns_q)
    if any(b < ns_q for b in buds) and res.gidx is not None:
        sl = lambda x: torch.cat([x[s * ns_q : s * ns_q + b] for s, b in enumerate(buds)])
        res = res._replace(
            updates=type(res.updates)(*[sl(x) for x in res.updates]),
            lc_samples=type(res.lc_samples)(*[sl(x) for x in res.lc_samples]),
            zeros=type(res.zeros)(*[sl(x) for x in res.zeros]),
        )
        gidx = sl(gidx)
    vol = None
    if mcfg.volume is not None:
        from .render.mcpg.volume import apply_dist_updates, compact_dist, render_volume

        vol_img, vol_mv, new_volume, vres = render_volume(
            accel, atlas, uniforms, config, mcfg, mcfg.volume, mstate, vstate, gbuf,
            schedule, packed=packed,
        )
        # the volume's rows follow the surface's in the global row order
        gidx_vol = queue_gidx(
            vres.updates.data.shape[0], max(mcfg.volume.volume_spp, 1), W, H, device=dev,
        )
        gidx = torch.cat([gidx, gidx_vol + surf_groups * H * W])
        cat = lambda a, b: type(a)(*[torch.cat([x, y]) for x, y in zip(a, b)])
        res = SurfaceResult(
            irradiance=res.irradiance,
            updates=cat(res.updates, vres.updates),
            lc_samples=cat(res.lc_samples, vres.lc_samples),
            zeros=cat(res.zeros, vres.zeros),
        )
        dmc = vstate.dist_mc
        dq = compact_dist(vres.dist, dmc.sum_w.numel(), gidx_vol)
        new_volume = new_volume._replace(dist_mc=apply_dist_updates(dmc, dq))
        vol = (new_volume, vol_img, vol_mv)
    cq = compact_queues(res, mcfg, gidx, gidx)
    return res.irradiance, apply_updates_compact(config.seed, mstate, cq, uniforms, mcfg), vol


def frame_core(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    state: FrameState,
    mcpg_config=None,
    schedule=None,
):
    """One frame of the whole image. Returns (new_state, outputs) with
    outputs {"hdr", "ldr", "irradiance", "gbuffer"}, and "volume" and
    "volume_mv" when the volume pass runs."""
    _check_supported(config)
    gbuf = render_gbuffer(accel, atlas, uniforms, config, schedule)
    new_restir = state.restir
    new_mcpg = state.mcpg
    new_ssmm = state.ssmm
    vol = None
    if config.integrator == "mcpg":
        from .render.mcpg import MCPGConfig

        irr, new_mcpg, vol = _render_mcpg(
            accel, atlas, uniforms, config, mcpg_config or MCPGConfig(), state.mcpg,
            state.volume, gbuf, schedule,
        )
    elif config.integrator == "restir":
        from .render.restir import ReSTIRConfig, render_restir

        irr, new_restir = render_restir(
            accel, atlas, uniforms, config, mcpg_config or ReSTIRConfig(),
            state.restir, gbuf, schedule,
        )
    elif config.integrator == "ssmm":
        from .render.ssmm import SSMMConfig, render_ssmm

        irr, new_ssmm = render_ssmm(
            accel, atlas, uniforms, config, mcpg_config or SSMMConfig(),
            state.ssmm, gbuf, schedule,
        )
    else:
        irr = render_pt(accel, atlas, uniforms, config, gbuf, schedule)
    it = state.iteration
    if config.denoise:
        # the denoise beauty path reads none of the plain accumulators
        # (SVGF integrates its own history): they keep their inputs
        acc_irr, acc_dir, acc_alb = state.accum_irradiance, state.accum_direct, state.accum_albedo
    else:
        acc_irr = accumulate(state.accum_irradiance, irr, it)
        acc_dir = accumulate(state.accum_direct, gbuf.irradiance, it)
        acc_alb = accumulate(state.accum_albedo, gbuf.albedo, it)
    new_state = FrameState(
        accum_irradiance=acc_irr, accum_direct=acc_dir, accum_albedo=acc_alb,
        iteration=it + 1, restir=new_restir, mcpg=new_mcpg, ssmm=new_ssmm,
        volume_svgf=state.volume_svgf,
    )
    if vol is not None:
        # the volume history is reprojected along the volume motion
        # vectors: under camera motion it tracks the fog instead of
        # ghosting
        acc_vol, acc_vol_len = accumulate_reprojected(
            state.accum_volume, state.accum_volume_len, vol[1], vol[2],
        )
        new_state = new_state._replace(
            volume=vol[0], accum_volume=acc_vol, accum_volume_len=acc_vol_len
        )
    # beauty path (the reference's wiring): with denoise, irradiance →
    # SVGF (+ albedo remodulate) → add direct emission (+ the volume's
    # own SVGF) → exposure → tonemap → TAA → FXAA
    if config.denoise:
        from .post.fxaa import fxaa
        from .post.svgf import svgf
        from .post.taa import taa

        new_svgf, filtered = svgf(
            state.svgf, irr[..., :3], irr[..., 3], gbuf.mv, gbuf.normal, gbuf.linear_z,
            gbuf.z_grad, gbuf.albedo[..., :3],
        )
        beauty_hdr = filtered + gbuf.irradiance[..., :3]
        if vol is not None:
            # the second SVGF instance, on the volume's history: its
            # reprojection follows the VOLUME motion vectors, its albedo
            # is all ones (the reference's 'one' Color node)
            new_vol_svgf, vol_filtered = svgf(
                state.volume_svgf, acc_vol[..., :3], acc_vol[..., 3], vol[2], gbuf.normal,
                gbuf.linear_z, gbuf.z_grad, torch.ones_like(acc_vol[..., :3]),
            )
            beauty_hdr = beauty_hdr + vol_filtered
            new_state = new_state._replace(volume_svgf=new_vol_svgf)
    else:
        beauty_hdr = (
            new_state.accum_irradiance[..., :3]
            * torch.clamp_min(new_state.accum_albedo[..., :3], 0.0)
            + new_state.accum_direct[..., :3]
        )
        if vol is not None:
            beauty_hdr = beauty_hdr + new_state.accum_volume[..., :3]
    # auto exposure (key / log-average luminance, merian Exposure node)
    lum = color_ops.yuv_luminance(beauty_hdr)
    log_mean = torch.log(lum + 1e-4).mean()
    scale = 0.18 / torch.clamp_min(torch.exp(log_mean), 1e-4)
    ldr = tonemap_reinhard_extended(beauty_hdr * scale)
    if config.denoise:
        # the TAA history is the LDR before FXAA
        ldr = taa(state.taa_prev, ldr, gbuf.mv)
        new_state = new_state._replace(svgf=new_svgf, taa_prev=ldr)
        ldr = fxaa(ldr)
    outputs = {"hdr": beauty_hdr, "ldr": ldr, "irradiance": irr, "gbuffer": gbuf}
    if vol is not None:
        outputs["volume"], outputs["volume_mv"] = vol[1], vol[2]
    return new_state, outputs


def render_frame(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    state: FrameState,
    mcpg_config=None,
    schedule=None,
):
    """One full frame on one device. Returns (new_state, outputs)."""
    return frame_core(accel, atlas, uniforms, config, state, mcpg_config=mcpg_config,
                      schedule=schedule)
