"""The frame: gbuffer → integrator → accumulate or denoise → exposure →
tonemap (→ TAA → FXAA when denoising).

Port of merian_quake_tpu/renderer.py for every integrator of the JAX
package's ``frame_core``: the path-traced (``pt``), the ReSTIR DI
(``restir``), the guided (``mcpg``, with the volume pass when
``MCPGConfig.volume`` is set) and the screen-space mixture-model
(``ssmm``) frames, with or without ``denoise`` (SVGF, and a second SVGF
on the volume's history). PyTorch runs eagerly, so ``render_frame`` is
``frame_core`` over the whole image; the state is updated out of place,
like the JAX package's. The integrator's config goes under the JAX
package's keyword ``mcpg_config`` (an MCPGConfig for ``mcpg``, a
ReSTIRConfig for ``restir``, an SSMMConfig for ``ssmm``), so that call
sites map one to one. ``schedule`` (an accel.woop.TraceSchedule; None:
the default routes) chooses the card's trace schedule, which the JAX
package takes from process environment switches; it changes no hit, and
the CPU oracle ignores it.

``compile_frame`` is the counterpart of the JAX package's jitted
``render_frame``: on the card it captures ``frame_core`` in one CUDA
graph (capture.CapturedStep) and replays it a frame; ``render_sequence``
renders through it. The per-frame values a captured frame reads are
device scalars (``Uniforms.frame``, ``FrameState.iteration``), and its
alpha loop reads nothing from the host: one alpha walk a trace on the
default routes, and under a schedule's list walker a round loop that keeps
its test on the device (accel.intersect.alpha_loop_on_device).

``frame_core`` renders an image-row slab when given ``y0``/``rows``, with
``mean_fn`` (the exposure's global mean), ``gather_fn`` (the guiding
queues of every slab) and ``shard_ctx`` (the halo exchanges and gathered
images, post.sharded.ShardCtx): the multi-device frame of
parallel/render.py. The defaults render the whole image on one device.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from .accel.build import AccelScene, build_accel, scene_features
from .accel.intersect import alpha_loop_on_device
from .models.procedural import SceneBundle
from .models.types import RenderConfig, TextureAtlas, Uniforms, device_scalars
from .ops import color as color_ops
from .post.accumulate import accumulate, accumulate_reprojected
from .post.svgf import init_svgf_state
from .post.tonemap import tonemap_reinhard_extended
from .render.gbuffer import render_gbuffer
from .render.pt import render_pt
from .utils import profiler

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


def _render_mcpg(accel, atlas, uniforms, config, mcfg, mstate, vstate, gbuf, schedule,
                 _surf=None, y0=0, rows=None, gather_fn=lambda x, groups=1: x,
                 shard_ctx=None):
    """The guided surface pass on MCPGState ``mstate``, the volume pass on
    VolumeState ``vstate`` when ``mcfg.volume`` is set, and the replay of
    their queues into the guiding state. Returns (irradiance image, new
    MCPGState, the volume's (new VolumeState, this frame's image, motion
    vectors) or None). ``frame_core`` and the frame graph's
    ``render_markovchain`` node both render through it. ``_surf``: a
    SurfaceResult to replay instead of rendering one (tests). On a row
    slab (``y0``/``rows``, ``shard_ctx``) each slab compacts its queues to
    1/n of the capacities and ``gather_fn`` gathers every slab's, so that
    every rank replays the same rows into its replica of the state."""
    from .render.mcpg.surface import (
        SurfaceResult, _seg_budgets, pack_tables, render_mcpg_surface,
    )
    from .render.mcpg.updates import apply_updates_compact, compact_queues, queue_gidx

    like = mstate.mc.f
    # both passes read the same packed tables: build them once
    with profiler.span("mcpg.pack", like):
        packed = pack_tables(mstate, uniforms)
    with profiler.span("mcpg.surface", like):
        res = (
            _surf if _surf is not None
            else render_mcpg_surface(
                accel, atlas, uniforms, config, mcfg, mstate, gbuf, schedule, packed=packed,
                y0=y0, rows=rows,
            )
        )
    W, H = config.width, config.height
    rows = H if rows is None else rows
    n_shards = shard_ctx.n if shard_ctx is not None else 1
    gather_img = shard_ctx.gather_rows if shard_ctx is not None else (lambda x: x)
    vol = None
    if mcfg.volume is not None:
        from .render.mcpg.volume import apply_dist_updates, compact_dist, render_volume

        with profiler.span("mcpg.volume", like):
            vol_img, vol_mv, new_volume, vres = render_volume(
                accel, atlas, uniforms, config, mcfg, mcfg.volume, mstate, vstate, gbuf,
                schedule, packed=packed, y0=y0, rows=rows, gather_img_fn=gather_img,
            )
    # the queues' replay into the guiding state: their row ids, the
    # concatenation, the compactions and both replays
    with profiler.span("mcpg.update", like):
        spp = max(config.spp, 1)
        surf_groups = spp * max(config.max_path_length - 1, 1)
        dev = res.updates.data.device
        gidx = (
            res.gidx if res.gidx is not None
            else queue_gidx(res.updates.data.shape[0], surf_groups, W, rows, y0, H, device=dev)
        )
        # live-lane compaction makes each segment's queue rows past its
        # static budget DEAD padding (surface pads the compacted emissions
        # back to ns rows): slice them off here so that compact_queues sorts
        # Σbudgets rows instead of segments·ns. In overflow frames the
        # full-width fallback can emit beyond the budget; those rows drop —
        # render output stays exact, guiding just learns from fewer samples
        # that frame.
        segs_n = max(config.max_path_length - 1, 0)
        ns_q = W * rows * spp
        buds = _seg_budgets(mcfg, segs_n, ns_q)
        if any(b < ns_q for b in buds) and res.gidx is not None:
            sl = lambda x: torch.cat([x[s * ns_q : s * ns_q + b] for s, b in enumerate(buds)])
            res = res._replace(
                updates=type(res.updates)(*[sl(x) for x in res.updates]),
                lc_samples=type(res.lc_samples)(*[sl(x) for x in res.lc_samples]),
                zeros=type(res.zeros)(*[sl(x) for x in res.zeros]),
            )
            gidx = sl(gidx)
        if mcfg.volume is not None:
            # the volume's rows follow the surface's in the global row order
            gidx_vol = queue_gidx(
                vres.updates.data.shape[0], max(mcfg.volume.volume_spp, 1), W, rows, y0, H,
                device=dev,
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
            dq = gather_fn(compact_dist(vres.dist, dmc.sum_w.numel(), gidx_vol, n_shards), 1)
            new_volume = new_volume._replace(dist_mc=apply_dist_updates(dmc, dq))
            vol = (new_volume, vol_img, vol_mv)
        cq = compact_queues(res, mcfg, gidx, gidx, n_shards=n_shards)
        cq = type(cq)(*[gather_fn(x, 1) for x in cq])
        new_mstate = apply_updates_compact(config.seed, mstate, cq, uniforms, mcfg)
        if profiler.counting():
            # the chain states that carry a weight after the replay, of all
            S = mcfg.mc_total_size
            profiler.count("mcpg.states_weighted", (new_mstate.mc.f[:S, 3] > 0.0).sum())
            profiler.count("mcpg.states", S)
    return res.irradiance, new_mstate, vol


def frame_core(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    state: FrameState,
    mcpg_config=None,
    schedule=None,
    _surf=None,
    y0=0,
    rows: int | None = None,
    mean_fn=lambda x: x,
    gather_fn=lambda x, groups=1: x,
    shard_ctx=None,
):
    """One frame over image rows [y0, y0 + rows) (default: the whole
    image). Returns (new_state, outputs) with outputs {"hdr", "ldr",
    "irradiance", "gbuffer"}, and "volume" and "volume_mv" when the volume
    pass runs, all of them the slab's.

    ``mean_fn`` reduces this slab's mean log luminance to the image's
    (post.sharded.ShardCtx.mean); ``gather_fn(x, groups)`` gathers every
    slab's guiding-update queue rows, so that every device applies the
    same update set to its replica of the guiding state; ``shard_ctx``
    (post.sharded.ShardCtx) switches the cross-pixel reads of ReSTIR and
    SSMM, the volume's forward projection, the volume accumulation and
    the denoise chain to their halo and gather routes. A slab needs it
    for every integrator but ``pt`` and ``mcpg`` without denoise or
    volume (raises otherwise; the JAX package asserts it for ReSTIR and
    SSMM)."""
    _check_supported(config)
    rows = config.height if rows is None else rows
    volume = config.integrator == "mcpg" and getattr(mcpg_config, "volume", None) is not None
    if rows != config.height and shard_ctx is None and (
        config.integrator in ("restir", "ssmm") or config.denoise or volume
    ):
        raise ValueError(f"{config.integrator} (denoise={config.denoise}, volume={volume}) on a "
                         "row slab needs a shard_ctx")
    gather_img = shard_ctx.gather_rows if shard_ctx is not None else (lambda x: x)
    like = state.accum_irradiance
    with profiler.span("gbuffer", like):
        gbuf = render_gbuffer(accel, atlas, uniforms, config, schedule, y0=y0, rows=rows)
    new_restir = state.restir
    new_mcpg = state.mcpg
    new_ssmm = state.ssmm
    vol = None
    if config.integrator == "mcpg":
        from .render.mcpg import MCPGConfig

        irr, new_mcpg, vol = _render_mcpg(
            accel, atlas, uniforms, config, mcpg_config or MCPGConfig(), state.mcpg,
            state.volume, gbuf, schedule, _surf, y0=y0, rows=rows, gather_fn=gather_fn,
            shard_ctx=shard_ctx,
        )
    elif config.integrator == "restir":
        from .render.restir import ReSTIRConfig, render_restir

        with profiler.span("restir", like):
            irr, new_restir = render_restir(
                accel, atlas, uniforms, config, mcpg_config or ReSTIRConfig(),
                state.restir, gbuf, schedule, y0=y0, rows=rows, shard_ctx=shard_ctx,
            )
    elif config.integrator == "ssmm":
        from .render.ssmm import SSMMConfig, render_ssmm

        with profiler.span("ssmm", like):
            irr, new_ssmm = render_ssmm(
                accel, atlas, uniforms, config, mcpg_config or SSMMConfig(),
                state.ssmm, gbuf, schedule, y0=y0, rows=rows, shard_ctx=shard_ctx,
            )
    else:
        with profiler.span("pt", like):
            irr = render_pt(accel, atlas, uniforms, config, gbuf, schedule, y0=y0, rows=rows)
    # everything after the integrator is the span "post": the accumulation,
    # the denoise chain, the exposure and tonemap, TAA and FXAA
    with profiler.span("post", like):
        it = state.iteration
        with profiler.span("post.accumulate", like):
            if config.denoise:
                # the denoise beauty path reads none of the plain accumulators
                # (SVGF integrates its own history): they keep their inputs
                acc_irr, acc_dir, acc_alb = (state.accum_irradiance, state.accum_direct,
                                             state.accum_albedo)
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
                    gather_fn=gather_img, y0=y0, rows=rows,
                )
                new_state = new_state._replace(
                    volume=vol[0], accum_volume=acc_vol, accum_volume_len=acc_vol_len
                )
        # beauty path (the reference's wiring): with denoise, irradiance →
        # SVGF (+ albedo remodulate) → add direct emission (+ the volume's
        # own SVGF) → exposure → tonemap → TAA → FXAA
        if config.denoise:
            if shard_ctx is not None:
                from .post.sharded import fxaa_sharded, svgf_sharded, taa_sharded

                svgf = partial(svgf_sharded, shard_ctx)
                taa = partial(taa_sharded, shard_ctx)
                fxaa = partial(fxaa_sharded, shard_ctx)
            else:
                from .post.fxaa import fxaa
                from .post.svgf import svgf
                from .post.taa import taa

            with profiler.span("post.svgf.surface", like):
                new_svgf, filtered = svgf(
                    state.svgf, irr[..., :3], irr[..., 3], gbuf.mv, gbuf.normal,
                    gbuf.linear_z, gbuf.z_grad, gbuf.albedo[..., :3],
                )
                beauty_hdr = filtered + gbuf.irradiance[..., :3]
            if vol is not None:
                # the second SVGF instance, on the volume's history: its
                # reprojection follows the VOLUME motion vectors, its albedo
                # is all ones (the reference's 'one' Color node)
                with profiler.span("post.svgf.volume", like):
                    new_vol_svgf, vol_filtered = svgf(
                        state.volume_svgf, acc_vol[..., :3], acc_vol[..., 3], vol[2],
                        gbuf.normal, gbuf.linear_z, gbuf.z_grad,
                        torch.ones_like(acc_vol[..., :3]),
                    )
                    beauty_hdr = beauty_hdr + vol_filtered
                new_state = new_state._replace(volume_svgf=new_vol_svgf)
        with profiler.span("post.exposure", like):
            if not config.denoise:
                beauty_hdr = (
                    new_state.accum_irradiance[..., :3]
                    * torch.clamp_min(new_state.accum_albedo[..., :3], 0.0)
                    + new_state.accum_direct[..., :3]
                )
                if vol is not None:
                    beauty_hdr = beauty_hdr + new_state.accum_volume[..., :3]
            # auto exposure (key / log-average luminance, merian Exposure node)
            lum = color_ops.yuv_luminance(beauty_hdr)
            log_mean = mean_fn(torch.log(lum + 1e-4).mean())
            scale = 0.18 / torch.clamp_min(torch.exp(log_mean), 1e-4)
            ldr = tonemap_reinhard_extended(beauty_hdr * scale)
        if config.denoise:
            # the TAA history is the LDR before FXAA
            with profiler.span("post.taa", like):
                ldr = taa(state.taa_prev, ldr, gbuf.mv)
            new_state = new_state._replace(svgf=new_svgf, taa_prev=ldr)
            with profiler.span("post.fxaa", like):
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
    with profiler.frame(state.accum_irradiance):
        return frame_core(accel, atlas, uniforms, config, state, mcpg_config=mcpg_config,
                          schedule=schedule)


def _frame_step(accel, atlas, config, mcpg_config, schedule, state, uniforms):
    """``frame_core`` with the alpha loop's test on the device: the step a
    compiled frame runs, on the card captured, on the CPU as it is."""
    with alpha_loop_on_device(), profiler.frame(state.accum_irradiance):
        return frame_core(accel, atlas, uniforms, config, state, mcpg_config=mcpg_config,
                          schedule=schedule)


class CompiledFrame:
    """The frame compiled once and run a frame at a time: ``cf(uniforms)``
    renders one frame from ``cf.state`` and returns (new state, outputs),
    the new state becoming ``cf.state``.

    On the card the first call warms up on a clone of the state (the
    caller's sequence does not advance), captures one ``frame_core`` in a
    CUDA graph into static buffers (the uniforms, with ``frame`` and
    ``player`` as device scalars, and the state) and every call replays
    it; the state is carried in place, copied into its static buffers at
    the graph's end (capture.CapturedStep). The state and the outputs a
    call returns ARE those static buffers: the next call overwrites them,
    so clone what must outlive it. A failed capture raises; nothing falls
    back to the eager frame. ``captured`` is the capture.CapturedStep
    after the first call on the card (None before, and on the CPU).

    ``set_state(state)`` makes ``state`` the one the next call renders
    from (after the capture: copied into the static state, in place).

    The accel and the atlas are those given here: a frame whose tables
    change renders them from the same tensors, written in place
    (accel.build.refresh_dynamic, accel.build.write_accel).

    On the CPU, which has no graphs, each call runs ``frame_core`` as it
    is, with the same interface and the alpha loop's test kept on the
    device, as the captured frame keeps it."""

    def __init__(self, accel, atlas, config, state, mcpg_config=None, schedule=None):
        _check_supported(config)
        dev = state.accum_irradiance.device
        if dev.type != "cpu" and (dev.type != "cuda" or not torch.cuda.is_available()):
            raise RuntimeError(f"compile_frame: a frame on {dev} is captured in a CUDA graph, "
                               "which needs a CUDA device")
        self.state = state
        self.captured = None
        self._on_card = dev.type == "cuda"
        self._step = partial(_frame_step, accel, atlas, config, mcpg_config, schedule)

    def __call__(self, uniforms: Uniforms):
        if not self._on_card:
            self.state, outputs = self._step(self.state, uniforms)
            return self.state, outputs
        from .capture import CapturedStep

        if self.captured is None:
            self.captured = CapturedStep(self._step, self.state, device_scalars(uniforms))
        self.state, outputs = self.captured(self.captured.state, uniforms)
        return self.state, outputs

    def set_state(self, state: FrameState) -> None:
        """Render the next frame from ``state``. After the capture it is
        written into the static state (capture.assign: a tensor the static
        state holds is kept as it is, another copied in; another structure,
        shape or Python value raises), which ``self.state`` stays."""
        if self.captured is None:
            self.state = state
        else:
            from .capture import assign

            assign(self.captured.state, state)


def compile_frame(accel: AccelScene, atlas: TextureAtlas, config: RenderConfig,
                  state: FrameState, mcpg_config=None, schedule=None) -> CompiledFrame:
    """The frame compiled for ``state``'s device, the port's counterpart of
    the JAX package's jitted ``render_frame``: a CompiledFrame, whose call
    on the uniforms renders a frame (on the card one CUDA graph's replay).
    Raises on a device that is neither the CPU nor an available card."""
    return CompiledFrame(accel, atlas, config, state, mcpg_config, schedule)


def render_sequence(
    bundle: SceneBundle, config: RenderConfig, frames: int = 1, mcpg_config=None,
    device="cuda", schedule=None,
):
    """Render ``frames`` frames of a static scene on ``device``,
    returning the final (state, outputs). The frames run through
    :func:`compile_frame` (on the card one captured graph, replayed a
    frame), as the JAX package's run the jitted ``render_frame``."""
    _check_supported(config)
    bundle = SceneBundle(*[x.to(device) for x in bundle])
    accel = build_accel(bundle.scene, bundle.atlas, device=device)
    config = config._replace(
        features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    )
    step = compile_frame(accel, bundle.atlas, config, init_state(config, mcpg_config, device=device),
                         mcpg_config, schedule)
    state, outputs = step.state, None
    for i in range(frames):
        state, outputs = step(bundle.uniforms._replace(frame=i))
    return state, outputs
