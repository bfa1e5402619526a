"""The frames on the card: the PT slice (3-4), ReSTIR (6-7), MCPG on city
and the map with their guided bounces (16-19), the court, the volume pass
and the production config (20-22), the denoise chain (23-24) and SSMM
(25)."""
from __future__ import annotations

import time

import numpy as np
import torch

from .common import (
    FOG_MU_T, H, MEAN_TOL, MPL, OPS_NEAREST, PIX_SHARE, PIX_TOL, SPP, SUBSET, W, bound_ms,
    check_exact, check_mcpg_finite, cuda_time, frames_run, guided_population, launches, log,
    mcpg_frames, mcpg_scene_config, prepass_ab, reset_launches, scene_1080, sync_sites,
    trace_split, woop_work,
)
from .fixtures import court, keep


def phase3(dev, smi, city_scene):
    """The slice: 6 PT frames of city at 1080p, K1 launched exactly 1 +
    SPP * (MPL - 1) times a frame; returns the launches."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    bundle, accel, config = city_scene
    state = init_state(config, device=dev)
    reset_launches()
    uniforms = bundle.uniforms
    frame_ms = []
    for i in range(6):
        before = woop.woop_nearest.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = render_frame(accel, bundle.atlas, uniforms._replace(frame=i), config, state)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        launched = woop.woop_nearest.launches - before
        if launched != 1 + SPP * (MPL - 1):
            raise AssertionError(f"frame {i}: K1 launched {launched} times, expected 5")
    pt_city = launches()
    if pt_city != {**{k: 0 for k in pt_city}, "woop_nearest": 6 * (1 + SPP * (MPL - 1))}:
        raise AssertionError(f"the path-traced city frames launched {pt_city}, expected K1 alone")
    for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]),
                    ("accum_irradiance", state.accum_irradiance),
                    ("accum_direct", state.accum_direct),
                    ("accum_albedo", state.accum_albedo)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name} is not finite")
    if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
        raise AssertionError("ldr has the wrong shape or is constant")
    steady = float(np.mean(frame_ms[2:]))
    rays = W * H * (1 + SPP * (MPL - 1))
    log(f"phase 3 slice city {W}x{H} spp {SPP} mpl {MPL} [{smi}]: launches {pt_city}; "
        f"cold {frame_ms[0]:.1f} ms, steady {steady:.1f} ms/frame "
        f"(frames {', '.join(f'{x:.1f}' for x in frame_ms)}), "
        f"{rays / steady / 1e3:.2f} Mrays/s; ldr mean {float(out['ldr'].mean()):.4f}")
    return pt_city


def phase4(dev):
    """The same PT frames at 64x36 on the CPU (the Möller–Trumbore oracle)
    and on the card (K1): the LDR images within the slice test's
    tolerance."""
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    small = RenderConfig(width=64, height=36, spp=SPP, max_path_length=MPL)
    _, out_cpu = render_sequence(city(device="cpu"), small, frames=3, device="cpu")
    _, out_gpu = render_sequence(city(device="cpu"), small, frames=3, device=dev)
    diff = (out_cpu["ldr"] - out_gpu["ldr"].cpu()).abs()
    share = float((diff.amax(-1) <= PIX_TOL).float().mean())
    mean = float(diff.mean())
    log(f"phase 4 cpu vs cuda 64x36 x3 frames: pixels within {PIX_TOL} {share:.5f}, "
        f"mean |d| {mean:.3e}, max |d| {float(diff.max()):.3e}")
    if share < PIX_SHARE or mean >= MEAN_TOL:
        raise AssertionError("CPU and card LDR images disagree")


def phase6(dev, smi, city_scene):
    """6 ReSTIR frames at 1080p; returns the launches of each kernel; then
    F4's frames with and without the proxy pre-pass."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    bundle, accel, city_config = city_scene
    config = RenderConfig(width=W, height=H, integrator="restir", features=city_config.features)
    rcfg = ReSTIRConfig()
    state = init_state(config, rcfg, device=dev)
    reset_launches()
    frame_ms = []
    for i in range(6):
        before = (woop.woop_nearest.launches, woop.woop_any.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=i), config,
                                  state, rcfg)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        got = (woop.woop_nearest.launches - before[0], woop.woop_any.launches - before[1])
        if got != (2, 1):
            raise AssertionError(f"ReSTIR frame {i}: (K1, K2) launched {got} times, expected (2, 1)")
    got = launches()
    if got["woop_stream"] or got["mt_dense"]:
        raise AssertionError(f"the city ReSTIR frames launched K3 or K8: {got}")
    res = state.restir.reservoirs
    for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]), ("irradiance", out["irradiance"]),
                    ("accum_irradiance", state.accum_irradiance), ("reservoir w", res.w),
                    ("reservoir p_target", res.p_target), ("reservoir y_pos", res.y_pos),
                    ("reservoir y_radiance", res.y_radiance)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"ReSTIR {name} is not finite")
    m_max = int(res.M.max())
    if m_max <= 1:
        raise AssertionError(f"ReSTIR: largest reservoir M is {m_max} after 6 frames")
    if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
        raise AssertionError("ReSTIR ldr has the wrong shape or is constant")
    steady = float(np.mean(frame_ms[2:]))
    log(f"phase 6 restir city {W}x{H} [{smi}]: K1 launches {got['woop_nearest']}, "
        f"K2 launches {got['woop_any']}; cold {frame_ms[0]:.1f} ms, steady {steady:.1f} "
        f"ms/frame (frames {', '.join(f'{x:.1f}' for x in frame_ms)}); max M {m_max}; "
        f"valid reservoirs {float((res.y_flags & 1).float().mean()):.4f}; "
        f"ldr mean {float(out['ldr'].mean()):.4f}")
    f4 = prepass_ab(6, "restir city", bundle, accel, config, dev, smi)
    keep(restir_city=(config, state, out))
    return got, f4


def phase7(dev):
    """ReSTIR at 64×36, 3 frames: the CPU oracle against the card."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.capture import WARMUP_STEPS
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    small = RenderConfig(width=64, height=36, integrator="restir")
    for name, rcfg in (("defaults", ReSTIRConfig()),
                       ("bias 2", ReSTIRConfig(temporal_bias_correction=2, spatial_bias_correction=2))):
        _, out_cpu = render_sequence(city(device="cpu"), small, frames=3, mcpg_config=rcfg,
                                     device="cpu")
        k2_before = woop.woop_any.launches
        _, out_gpu = render_sequence(city(device="cpu"), small, frames=3, mcpg_config=rcfg,
                                     device=dev)
        k2 = woop.woop_any.launches - k2_before
        # a captured sequence: the wrapper launches in the warm-up frames and
        # records into the graph once; the replays launch the graph
        expect = (WARMUP_STEPS + 1) * (3 if rcfg.temporal_bias_correction == 2 else 1)
        if k2 != expect:
            raise AssertionError(f"phase 7 {name}: K2 launched {k2} times, expected {expect}")
        diff = (out_cpu["ldr"] - out_gpu["ldr"].cpu()).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        mean = float(diff.mean())
        log(f"phase 7 restir {name} cpu vs cuda 64x36 x3 frames (captured on the card): K2 "
            f"launches through the wrapper {k2} (the capture's warm-up and capture); pixels within "
            f"{PIX_TOL} {share:.5f}, mean |d| {mean:.3e}, max |d| {float(diff.max()):.3e}")
        if share < PIX_SHARE or mean >= MEAN_TOL:
            raise AssertionError(f"ReSTIR {name}: CPU and card LDR images disagree")


def phase16(dev, smi, city_scene, city1600):
    """City MCPG at 1080p: 16 frames from an empty state, no host read in
    a steady frame, the sorted-bounce A/B, the guided ray population, and
    one reading under a trace schedule on city(1600)."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.render.mcpg import surface
    from merian_quake_tpu_torch.renderer import render_frame

    bundle, accel, config = city_scene
    config, mcfg = mcpg_scene_config(config)
    state, out, counts, frame_ms, (live, applied) = mcpg_frames(
        16, "mcpg city", dev, bundle, accel, config, mcfg, 16, (12, 16), {"woop_nearest": 3}, smi)
    if counts != {**{k: 0 for k in counts}, "woop_nearest": 48}:
        raise AssertionError(f"the city MCPG frames launched {counts}, expected K1 alone, 48 times")
    if not (live[0] > 0 and live[-1] > live[0] and applied[0] > 0
            and all(b > a for a, b in zip(applied, applied[1:]))):
        raise AssertionError(f"guiding does not learn: states {live}, light cache {applied}")

    # a steady default frame reads no device value from the host: any
    # synchronizing call raises under this mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=16), config,
                                  state, mcfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("phase 16 mcpg city frame 16 under torch.cuda.set_sync_debug_mode('error'): no "
        "synchronizing call")

    state, pops = guided_population(bundle, accel, config, mcfg, state, 17)

    # the bounce coherence sort on the guided frame: as they lie, sorted,
    # sorted, as they lie; one frame a turn, 2 turns each
    plain = surface.trace_ray
    ab = {"none": [], "sort": []}
    try:
        for i, label in enumerate(("none", "sort", "sort", "none", "none", "sort", "sort", "none")):
            surface.trace_ray = plain if label == "none" else (
                lambda *a, **k: plain(*a, **{**k, "sort_rays": True}))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=18 + i),
                                      config, state, mcfg)
            torch.cuda.synchronize()
            ab[label].append((time.perf_counter() - t0) * 1e3)
    finally:
        surface.trace_ray = plain
    check_mcpg_finite("mcpg city after the A/B", state, out)
    last = (config, mcfg, bundle.uniforms._replace(frame=25), state, out)
    log(f"phase 16 mcpg city bounce sort A/B [{smi}]: as they lie "
        f"{' / '.join(f'{x:.1f}' for x in ab['none'])} ms/frame, sorted "
        f"{' / '.join(f'{x:.1f}' for x in ab['sort'])} ms/frame (frames 18-25, host clock)")

    # one reading under a trace schedule, on city(1600): default routes
    # against TraceSchedule(True, 8, 32) (the two bounce segments sorted by
    # the target key; the visit list and the compacting node walk for all three)
    b16, a16, c16cfg, _ = city1600
    cfg16, _ = mcpg_scene_config(c16cfg)
    sched_paths = {}
    for path, sched, expect in (
        ("mcpg_1600", None, {"woop_nearest": 3}),
        ("mcpg_1600_nodes_compact", woop.TraceSchedule(True, 8, 32),
         {"target_keys": 2, "visit_list": 3, "woop_list": 3, "woop_list_nodes": 3,
          "woop_list_compact": 3}),
    ):
        _, _, sched_paths[path], _, _ = mcpg_frames(
            16, path, dev, b16, a16, cfg16, mcfg, 6, (2, 6), expect, smi, schedule=sched)
    frames = {"ms": float(np.mean(frame_ms[12:16])), "cold": frame_ms[0]}
    keep(mcpg_city_frames=frames, mcpg_city_pops=pops, mcpg_city_last=last)
    return counts, sched_paths, frames


def phase17(dev, smi, map_scene):
    """Map MCPG at 1080p: 9 frames, exactly 3 K3 launches a frame and no
    K1; then the guided ray population of frame 9."""
    bundle, accel, config = map_scene
    cfg, mcfg = mcpg_scene_config(config)
    state, _, counts, frame_ms, (live, applied) = mcpg_frames(
        17, "mcpg map", dev, bundle, accel, cfg, mcfg, 9, (6, 9), {"woop_stream": 3}, smi)
    if counts != {**{k: 0 for k in counts}, "woop_stream": 27}:
        raise AssertionError(f"the map MCPG frames launched {counts}, expected K3 alone, 27 times")
    if not (live[-1] > live[0] > 0 and applied[-1] > applied[0] > 0):
        raise AssertionError(f"guiding does not learn on the map: {live}, {applied}")
    _, pops = guided_population(bundle, accel, cfg, mcfg, state, 9)
    keep(mcpg_map_pops=pops)
    return counts, {"ms": float(np.mean(frame_ms[6:9])), "cold": frame_ms[0]}


def phase18(dev, smi, city_scene, map_scene, mcpg_city_pops, mcpg_map_pops):
    """K1 on city's and K3 on the map's guided bounce rays (phases 16 and
    17), as :func:`guided_bounce` holds them."""
    from merian_quake_tpu_torch.accel import woop

    return (guided_bounce(dev, "city", city_scene[1], mcpg_city_pops[0], woop.woop_nearest,
                          woop.woop_stream, smi),
            guided_bounce(dev, "map", map_scene[1], mcpg_map_pops[0], woop.woop_stream,
                          woop.woop_nearest, smi))


def guided_bounce(dev, name, accel, pop, kernel, other, smi, what="mcpg bounce", phase=18):
    """K1 (city) or K3 (map) on one MCPG bounce segment's rays (or on
    another population ``what``): against its plain version on a
    65,536-ray subset and against the other route, forced, on the whole
    population, bit for bit; time in turns, pairs tested, bound and lane
    use."""
    from merian_quake_tpu_torch.accel import woop

    o, d, t_max = pop
    n = o.shape[0]
    kname = "K1" if kernel is woop.woop_nearest else "K3"
    oname = "K3" if kernel is woop.woop_nearest else "K1"
    mid = slice(n // 2, n // 2 + SUBSET)
    sub = woop.k1_inputs(accel, o[mid].contiguous(), d[mid].contiguous(),
                         torch.zeros(SUBSET, device=dev), t_max[mid].contiguous())
    errs = [check_exact(phase, f"{name} {what} {SUBSET} {kname} vs plain", kernel(*sub),
                        woop.intersect_woop_reference(sub[0], sub[1]))]
    args = woop.k1_inputs(accel, o, d, torch.zeros(n, device=dev), t_max)
    if args[0].shape[1] % 128:
        raise AssertionError("the packed ray count is not a multiple of 128")
    errs.append(check_exact(phase, f"{name} {what} {n} {kname} vs {oname} forced",
                            kernel(*args), other(*args)))
    k, f = (lambda: kernel(*args)), (lambda: other(*args))
    k_1, f_1, f_2, k_2 = cuda_time(k, 10), cuda_time(f, 10), cuda_time(f, 10), cuda_time(k, 10)
    p_1 = cuda_time(lambda: woop.intersect_woop_reference(sub[0], sub[1]), 1)
    s_1 = cuda_time(lambda: kernel(*sub), 10)
    ops, nbytes = woop_work(kernel, args)
    bnd, by = bound_ms(ops, nbytes)
    split = trace_split(phase, f"{name} {what} {kname}", kernel, args, smi)
    live = float((t_max > 0).float().mean())
    log(f"phase {phase} timing {name} {what} {n} rays (live {live:.4f}) [{smi}]: {kname} "
        f"{k_1:.3f} / {k_2:.3f} ms, {oname} forced {f_1:.3f} / {f_2:.3f} ms; on {SUBSET} rays "
        f"plain {p_1:.1f} ms, {kname} {s_1:.3f} ms; bound {bnd:.4f} ms ({by}; "
        f"{ops / OPS_NEAREST:.4g} pairs tested); lane use {split['lane_use']:.4f}")
    return {"ms": (k_1 + k_2) / 2, "other_ms": (f_1 + f_2) / 2, "plain_ms_subset": p_1,
            "ms_subset": s_1, "bound_ms": bnd, "bound_by": by, "lane_use": split["lane_use"],
            "rays": n, "live": live, "max_abs_err": max(errs)}


# phase 19's bounds, read on an NVIDIA H100 80GB HBM3 (700 W) against its
# host's CPU, the same in three runs: after 4 frames at 64x36 the LDR
# images' mean |d| read 1.037e-5, the states with sum_w > 0 16,643 (CPU)
# and 16,644 (card), the touched light-cache cells 11,736 on both. Pinned
# with at most twice that room (two of a count that read equal or one apart).
MCPG_LDR_MEAN_4 = 2e-5
MCPG_COUNT_ABS = 2
# 64 accumulated frames of mcpg and of pt, mean irradiance on the pixels
# the image uses: both estimate the same integral (read 0.0043 apart)
ESTIMATOR_REL = 0.01


def phase19(dev):
    """MCPG at 64×36 on city: the CPU oracle against the card (frame 0
    inside PT's tolerance; after 4 frames the LDR, the live chain states
    and the touched light-cache cells inside pinned bounds), and the
    estimator against PT's on the card after 64 accumulated frames."""
    from merian_quake_tpu_torch.capture import WARMUP_STEPS
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    small = RenderConfig(width=64, height=36, spp=SPP, max_path_length=MPL, integrator="mcpg")
    mcfg = MCPGConfig()
    for frames in (1, 4):
        k1 = launches()["woop_nearest"]
        sc, oc = render_sequence(city(device="cpu"), small, frames=frames, mcpg_config=mcfg,
                                 device="cpu")
        if launches()["woop_nearest"] != k1:
            raise AssertionError("the CPU MCPG frames launched K1")
        sg, og = render_sequence(city(device="cpu"), small, frames=frames, mcpg_config=mcfg)
        # render_sequence runs a captured frame on the card: the wrappers
        # launch during its warm-up frames and record into the graph once
        if launches()["woop_nearest"] != k1 + 3 * (WARMUP_STEPS + 1) or og["ldr"].device != dev:
            raise AssertionError("the card's MCPG frames did not launch K1 3 times a frame "
                                 "through the wrapper in the capture's warm-up and capture")
        diff = (oc["ldr"] - og["ldr"].cpu()).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        mean = float(diff.mean())
        counts = {
            "states": (int((sc.mcpg.mc.sum_w > 0).sum()), int((sg.mcpg.mc.sum_w > 0).sum())),
            "lc cells": (int((sc.mcpg.lc.N > 0).sum()), int((sg.mcpg.lc.N > 0).sum())),
        }
        same_i = float((sc.mcpg.mc.i == sg.mcpg.mc.i.cpu()).all(-1).float().mean())
        log(f"phase 19 mcpg cpu vs cuda 64x36 x{frames} frames: pixels within {PIX_TOL} "
            f"{share:.5f}, mean |d| {mean:.3e}, max |d| {float(diff.max()):.3e}; (cpu, card) "
            f"{counts}; mc.i rows equal {same_i:.6f}")
        if share < PIX_SHARE or mean >= (MEAN_TOL if frames == 1 else MCPG_LDR_MEAN_4):
            raise AssertionError(f"MCPG x{frames}: CPU and card LDR images disagree")
        for what, (a, b) in counts.items():
            if a <= 0 or abs(a - b) > MCPG_COUNT_ABS:
                raise AssertionError(f"MCPG x{frames}: {what} differ, cpu {a} card {b}")

    means = {}
    for integrator in ("mcpg", "pt"):
        cfg = small._replace(integrator=integrator)
        st, _ = render_sequence(city(device="cpu"), cfg, frames=64,
                                mcpg_config=mcfg if integrator == "mcpg" else None)
        used = st.accum_albedo[..., :3].amax(-1) > 0
        means[integrator] = float(st.accum_irradiance[..., :3][used].mean())
    rel = abs(means["mcpg"] - means["pt"]) / means["pt"]
    log(f"phase 19 estimator 64x36 x64 accumulated frames on the card: mean irradiance on the "
        f"pixels the image uses mcpg {means['mcpg']:.5f}, pt {means['pt']:.5f}, relative "
        f"difference {rel:.4f} (bound {ESTIMATOR_REL})")
    if rel > ESTIMATOR_REL:
        raise AssertionError("the guided estimator and the path tracer's disagree")


# the fogged court's CPU-vs-card bounds at 64x36 after 4 frames: those of
# tests/test_torch_volume_slice.py, read from the JAX package's own
# jitted-vs-op-by-op spread (the image border's history validity is an
# ulp's decision under a still camera)
VOLUME_LDR = (0.94, 2.55e-3)
VOLUME_IMAGE = (0.995, 1e-5)
# the court's CPU-vs-card LDR bound: tests/test_torch_scenes.py's against
# the JAX package's jitted run, read from its own jitted-vs-op-by-op
# spread (98.48%, 3.10e-4): the grates' alpha test and the water's
# warped texels turn on the hit's barycentrics, which the Woop test and
# the oracle's Möller-Trumbore round apart
COURT_LDR = (0.98, 3.9e-4)


class AlphaLoop:
    """Counts and times ``trace_nearest``'s alpha loops on the card: while
    installed, every ``intersect`` call (one K1 or K3 launch on the card)
    and every ``trace_nearest`` call given a texture atlas (the loop: one
    alpha walk on the default routes, no ``intersect`` call) is counted;
    CUDA events and the host clock around each loop give its device and
    host time."""

    def __init__(self):
        import importlib

        # the modules (accel/__init__ binds the name ``intersect`` to a function)
        imod = importlib.import_module("merian_quake_tpu_torch.accel.intersect")
        tmod = importlib.import_module("merian_quake_tpu_torch.render.trace")
        self.mods = (imod, tmod)
        self.plain_intersect, self.plain_nearest = imod.intersect, imod.trace_nearest
        self.reset()

    def reset(self):
        self.intersects = self.loops = 0
        self.events, self.host_s = [], 0.0

    def _intersect(self, *a, **k):
        self.intersects += 1
        return self.plain_intersect(*a, **k)

    def _nearest(self, accel, tex, *a, **k):
        if tex is None:
            return self.plain_nearest(accel, tex, *a, **k)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = self.plain_nearest(accel, tex, *a, **k)
        e1.record()
        self.host_s += time.perf_counter() - t0
        self.events.append((e0, e1))
        self.loops += 1
        return out

    def __enter__(self):
        imod, tmod = self.mods
        imod.intersect, imod.trace_nearest, tmod.trace_nearest = (
            self._intersect, self._nearest, self._nearest)
        return self

    def __exit__(self, *exc):
        imod, tmod = self.mods
        imod.intersect, imod.trace_nearest, tmod.trace_nearest = (
            self.plain_intersect, self.plain_nearest, self.plain_nearest)

    def device_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


def court_frames(phase, path, dev, bundle, accel, config, mcfg, frames, window, rays, smi):
    """``frames`` frames of a court path at 1080p with the launch counts set
    to 0 just before and read just after; every frame launches one alpha
    walk a ``trace_nearest`` call (its alpha loop), K1 for each other
    ``intersect`` call (none on the court) and nothing else but K2 on
    ReSTIR's visibility; then one more frame whose synchronizing calls are
    read: none may be in the alpha loop (intersect.py, woop.py). Returns
    (state, out, the path's launches, {"ms", "cold", the per-frame loop
    numbers})."""
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    state = init_state(config, mcfg, device=dev)
    probe = AlphaLoop()
    reset_launches()
    frame_ms, per = [], []
    with probe:
        for i in range(frames + 1):
            before = launches()
            probe.reset()
            step = lambda: render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=i),
                                        config, state, mcfg)
            if i == frames:  # the extra frame: its synchronizing calls
                (state, out), sites = sync_sites(step)
                loop_dev = probe.device_ms()
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, out = step()
                torch.cuda.synchronize()
                frame_ms.append((time.perf_counter() - t0) * 1e3)
            got = {k: v - before[k] for k, v in launches().items()}
            k2 = got.pop("woop_any")
            if (got["woop_nearest"] != probe.intersects or probe.loops == 0
                    or got["woop_nearest_alpha"] != probe.loops
                    or any(v for k, v in got.items() if k not in ("woop_nearest",
                                                                  "woop_nearest_alpha"))
                    or (k2 > 0) != (config.integrator == "restir")):
                raise AssertionError(f"{path} frame {i}: launched {got} and K2 {k2} for "
                                     f"{probe.intersects} intersect calls and {probe.loops} "
                                     f"alpha loops")
            if i < frames:
                per.append((got["woop_nearest"], got["woop_nearest_alpha"], k2, probe.loops,
                            probe.host_s * 1e3, probe.device_ms()))
    counts = launches()
    for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]),
                    ("accum_irradiance", state.accum_irradiance)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{path} {name} is not finite")
    if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
        raise AssertionError(f"{path} ldr has the wrong shape or is constant")
    in_loop = [x for x in sites if x.split(":")[0] in ("intersect.py", "woop.py")]
    if in_loop:
        raise AssertionError(f"{path}: the alpha loop synchronizes: {in_loop}")
    lo, hi = window
    steady = float(np.mean(frame_ms[lo:hi]))
    k1, walks, k2, loops, host_ms, dev_ms = (float(np.mean(c)) for c in zip(*per[lo:hi]))
    log(f"phase {phase} {path} {W}x{H} spp {config.spp} mpl {config.max_path_length} [{smi}]: "
        f"launches { {k: v for k, v in counts.items() if v} }; cold {frame_ms[0]:.1f} ms, mean of "
        f"frames {lo}-{hi - 1} {steady:.1f} ms/frame, {rays / steady / 1e3:.2f} Mrays/s (frames "
        f"{', '.join(f'{x:.1f}' for x in frame_ms)}); a frame (mean of the same): K1 {k1:.1f}, "
        f"alpha walks {walks:.1f} for {loops:.1f} alpha loops, K2 {k2:.1f}, the loops "
        f"{host_ms:.2f} ms on the host clock and {dev_ms:.2f} ms between their CUDA events; "
        f"frame {frames}: {len(sites)} synchronizing calls ({sorted(set(sites))}), none in the "
        f"alpha loop (loops {loop_dev:.2f} ms on the device); ldr mean "
        f"{float(out['ldr'].mean()):.4f}")
    return state, out, counts, {"ms": steady, "cold": frame_ms[0], "k1_per_frame": k1,
                                "alpha_walks_per_frame": walks, "alpha_loops": loops,
                                "loop_host_ms": host_ms, "loop_device_ms": dev_ms,
                                "syncs": len(sites)}


def cpu_vs_card(phase, name, bundle_fn, config, mcfg, frames, bounds, report=()):
    """``frames`` frames of a small ``config`` on the CPU (oracle) and on
    the card (K1, or the alpha walk on a scene with alpha tests): each
    output of ``bounds`` ({key: (share within 1e-3, mean |d|)})
    within its bound; the outputs in ``report`` printed beside them."""
    from merian_quake_tpu_torch.renderer import render_sequence

    k1 = lambda: launches()["woop_nearest"] + launches()["woop_nearest_alpha"]
    before = k1()
    _, oc = render_sequence(bundle_fn(), config, frames=frames, mcpg_config=mcfg, device="cpu")
    _, og = render_sequence(bundle_fn(), config, frames=frames, mcpg_config=mcfg)
    if k1() == before or og["ldr"].device.type != "cuda":
        raise AssertionError(f"{name}: the card's frames did not launch K1 or the alpha walk")
    for key, (share_min, mean_max) in bounds.items():
        diff = (oc[key] - og[key].cpu()).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        mean = float(diff.mean())
        log(f"phase {phase} {name} cpu vs cuda {config.width}x{config.height} x{frames} frames "
            f"{key}: pixels within {PIX_TOL} {share:.5f} (bound {share_min}), mean |d| "
            f"{mean:.3e} (bound {mean_max}), max |d| {float(diff.max()):.3e}")
        if share < share_min or mean >= mean_max:
            raise AssertionError(f"{name} {key}: CPU and card images disagree")
    for key in report:
        diff = (oc[key] - og[key].cpu()).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        log(f"phase {phase} {name} cpu vs cuda {config.width}x{config.height} x{frames} frames "
            f"{key} (not held): pixels within {PIX_TOL} {share:.5f}, mean |d| "
            f"{float(diff.mean()):.3e}, max |d| {float(diff.max()):.3e}")


def phase20(dev, smi):
    """The court at 1080p: PT, ReSTIR and MCPG frames with their alpha
    loops counted; CPU against card at 64x36."""
    from merian_quake_tpu_torch.models.procedural import outdoor_court
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig

    bundle, accel, config = court(dev)
    rays = W * H * (1 + SPP * (MPL - 1))
    paths, stats = {}, {}
    for integrator, mcfg in (("pt", None), ("restir", ReSTIRConfig()), ("mcpg", MCPGConfig())):
        _, _, paths[f"court_{integrator}"], stats[integrator] = court_frames(
            20, f"court {integrator}", dev, bundle, accel, config._replace(integrator=integrator),
            mcfg, 6, (2, 6), rays, smi)
    small = RenderConfig(width=64, height=36, spp=SPP, max_path_length=MPL)
    for integrator, mcfg in (("pt", None), ("restir", ReSTIRConfig()), ("mcpg", MCPGConfig())):
        # MCPG: frame 0 (unguided), as phase 19 holds city's
        cpu_vs_card(20, f"court {integrator}", lambda: outdoor_court(device="cpu"),
                    small._replace(integrator=integrator), mcfg,
                    1 if integrator == "mcpg" else 2, {"ldr": COURT_LDR})
    return paths, stats


def volume_population(bundle, accel, config, mcfg, state, frame):
    """One more volume frame with the volume pass's traces recorded:
    returns (the new state, [(origin, direction, t_max) of each volume
    sample]) as the pass hands them to ``trace_ray`` (every ray live)."""
    from merian_quake_tpu_torch.render.mcpg import volume
    from merian_quake_tpu_torch.render.trace import T_MAX
    from merian_quake_tpu_torch.renderer import render_frame

    plain, seen = volume.trace_ray, []

    def record(acc, atlas, uniforms, pos, wi, *a, **k):
        seen.append((pos.contiguous(), wi.contiguous(), torch.full_like(pos[:, 0], T_MAX)))
        return plain(acc, atlas, uniforms, pos, wi, *a, **k)

    volume.trace_ray = record
    try:
        state, _ = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=frame), config,
                                state, mcfg)
    finally:
        volume.trace_ray = plain
    if len(seen) != mcfg.volume.volume_spp or seen[0][0].shape[0] != W * H:
        raise AssertionError("the volume pass traced other populations than W·H a sample")
    return state, seen


def phase21(dev, smi):
    """The fogged court, MCPG + VolumeConfig(), at 1080p: 9 frames, the
    distance states learning; K1 on the volume pass's scatter rays; CPU
    against card at 64x36 over 4 frames."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.models.procedural import outdoor_court
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig

    bundle, accel, config = court(dev, FOG_MU_T)
    config = config._replace(integrator="mcpg")
    mcfg = MCPGConfig(volume=VolumeConfig())
    rays = W * H * (1 + SPP * (MPL - 1) + mcfg.volume.volume_spp)
    seen_live = []
    from merian_quake_tpu_torch import renderer

    plain_frame = renderer.render_frame

    def frame_and_states(*a, **k):
        out = plain_frame(*a, **k)
        seen_live.append(out[0].volume.dist_mc.sum_w)
        return out

    renderer.render_frame = frame_and_states
    try:
        state, out, counts, stats = court_frames(21, "court fog mcpg + volume", dev, bundle, accel,
                                                 config, mcfg, 9, (6, 9), rays, smi)
    finally:
        renderer.render_frame = plain_frame
    live = [int((x > 0).sum()) for x in seen_live]
    vol = out["volume"]
    if not (bool(torch.isfinite(state.accum_volume).all()) and float(vol[..., :3].mean()) > 0.0):
        raise AssertionError("the fogged court's volume image is not finite or is black")
    if not (live[0] > 0 and live[-1] > live[0]):
        raise AssertionError(f"the distance states do not learn: {live}")
    log(f"phase 21 court fog (mu_t {FOG_MU_T}) distance-MC states with sum_w > 0 per frame {live} "
        f"(of {state.volume.dist_mc.sum_w.numel()}); chain states with sum_w > 0 "
        f"{int((state.mcpg.mc.sum_w > 0).sum())}; volume image mean "
        f"{float(vol[..., :3].mean()):.5f}, accumulated {float(state.accum_volume[..., :3].mean()):.5f}")

    _, pops = volume_population(bundle, accel, config, mcfg, state, 10)
    g_vol = guided_bounce(dev, "court fog", accel, pops[0], woop.woop_nearest, woop.woop_stream,
                          smi, what="volume scatter", phase=21)

    small = RenderConfig(width=64, height=36, spp=1, max_path_length=MPL, integrator="mcpg")
    cpu_vs_card(21, "court fog mcpg + volume", lambda: outdoor_court(FOG_MU_T, device="cpu"),
                small, mcfg, 4, {"ldr": VOLUME_LDR, "volume": VOLUME_IMAGE})
    return counts, stats, g_vol


def phase22(dev, smi, city_scene):
    """``production_config()`` on city at 1080p: two settle frames, then 9
    frames from an empty state (bench.py's window, frames 6-8), exactly 3
    + volume_spp K1 launches a frame; peak device memory; one
    ``pack_states_draw``; a steady frame with no synchronizing call."""
    from merian_quake_tpu_torch.render.mcpg import grids
    from merian_quake_tpu_torch.render.mcpg.config import production_config
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    bundle, accel, config = city_scene
    cfg, _ = mcpg_scene_config(config)
    prod = production_config()
    state = init_state(cfg, prod, device=dev)
    for i in range(2):  # settle: the caching allocator's first frames
        state, _ = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=1000 + i), cfg,
                                state, prod)
    del state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    k1 = 3 + prod.volume.volume_spp
    rays = W * H * (1 + SPP * (MPL - 1) + prod.volume.volume_spp)
    state, out, counts, frame_ms, (live, applied) = mcpg_frames(
        22, "production city", dev, bundle, accel, cfg, prod, 9, (6, 9), {"woop_nearest": k1}, smi,
        rays=rays)
    peak = torch.cuda.max_memory_allocated()
    if counts != {**{k: 0 for k in counts}, "woop_nearest": 9 * k1}:
        raise AssertionError(f"the production frames launched {counts}, expected K1 alone")
    if not (live[-1] > live[0] > 0 and applied[-1] > applied[0] > 0):
        raise AssertionError(f"production guiding does not learn: {live}, {applied}")
    dist_live = int((state.volume.dist_mc.sum_w > 0).sum())
    pack = cuda_time(lambda: grids.pack_states_draw(state.mcpg.mc, bundle.uniforms.cl_time), 5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=9), cfg,
                                  state, prod)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check_mcpg_finite("production city", state, out)
    steady = float(np.mean(frame_ms[6:9]))
    log(f"phase 22 production city [{smi}]: {prod.mc_total_size} chain states, {prod.lc_size} "
        f"light-cache cells, volume spp {prod.volume.volume_spp}; cold {frame_ms[0]:.1f} ms, "
        f"frames 6-8 {steady:.1f} ms/frame = {rays / steady / 1e3:.2f} Mrays/s ({rays} rays a "
        f"frame); peak device memory {peak / 2**30:.3f} GiB; one pack_states_draw {pack:.3f} ms "
        f"(a {state.mcpg.mc.f.shape[0]} x 8 table); distance states with sum_w > 0 "
        f"{dist_live} (city has no fog: mu_t = 0, nothing scatters); frame 9 under torch.cuda.set_sync_debug_mode('error'): no synchronizing "
        f"call")
    return counts, {"ms": steady, "cold": frame_ms[0], "peak_bytes": peak, "pack_ms": pack}


def spread_bound(share, mean, margin=0.02):
    """A denoised frame's CPU-vs-card bound at 64x36 over 3 frames: the
    sequence bound of tests/test_torch_denoise_slice.py (cornell_box PT),
    test_torch_ssmm_slice.py (cornell_box SSMM) or
    test_torch_denoise_volume.py (the fogged court, ``margin`` 0.05), read
    from the JAX package's own jitted-vs-op-by-op spread
    (scripts/denoise_spread.py): its share within 1e-3 less ``margin``,
    1.25x its mean |d|."""
    return share - margin, 1.25 * mean


# The card's trace (Woop) and the CPU oracle (Moller-Trumbore) round hit
# distances and motion vectors apart, so under a still camera SVGF's history
# validity flips on the image border (1.6% of the box's pixels) and CUDA's
# exp and pow differ from the CPU's by an ulp: the denoised HDR image's
# CPU-vs-card spread on the box (56.8% within 1e-3, mean 7.85e-3 on an
# NVIDIA H100 80GB HBM3) is wider than the JAX package's own (70.6%,
# 3.16e-3). So the LDR
# image is held to the test's bound, the HDR image is printed, and the chain
# itself is held on identical inputs (chain_cpu_vs_card).
DENOISE_PT = {"ldr": spread_bound(0.13845, 7.573e-3)}
DENOISE_VOLUME = {"ldr": spread_bound(0.44748, 2.149e-3, 0.05),
                  "volume": spread_bound(0.99826, 1.139e-4, 0.05)}
# SSMM's chains drift between the CPU and the card as between the JAX
# package's two runs, so its raw irradiance is held to that spread (the
# pass the denoiser does not feed back into); the denoiser spreads a moved
# chain's pixel, so the denoised SSMM images are printed (LDR 27.9% within
# 1e-3, mean 8.63e-3 on the box on an NVIDIA H100 80GB HBM3)
SSMM_IRRADIANCE = {"irradiance": spread_bound(0.93620, 9.740e-2)}
# the chain on identical inputs, CPU against card: tests/test_torch_post.py's
# filter tolerance for SVGF and TAA; FXAA's edge decisions turn on an ulp of
# its input (96.9% of pixels within 1e-3 on an NVIDIA H100 80GB HBM3)
CHAIN_TOL = dict(rtol=1e-5, atol=1e-6)
FXAA_SHARE = 0.95
# tests/test_ssmm.py:55-57: accumulated SSMM within 15% of PT's mean
SSMM_ESTIMATOR_REL = 0.15


class DenoiseSplit:
    """CUDA events around the denoise chain's stages while installed: each
    ``svgf`` call (one an SVGF instance: the surface's, then the volume's),
    its temporal kernel (``svgf_temporal``) and à-trous passes
    (``svgf_atrous``), ``taa`` and ``fxaa``. A frame ends with its
    ``fxaa``. Exposure and tonemap (with the first-hit emission and the
    volume added) are the time between the last SVGF's end and TAA's
    start."""

    STAGES = ("svgf", "svgf_temporal", "svgf_atrous", "taa", "fxaa")

    def __init__(self):
        import importlib

        mod = importlib.import_module
        svgf = mod("merian_quake_tpu_torch.post.svgf")
        self.owner = {"svgf": svgf, "svgf_temporal": svgf, "svgf_atrous": svgf,
                      "taa": mod("merian_quake_tpu_torch.post.taa"),
                      "fxaa": mod("merian_quake_tpu_torch.post.fxaa")}
        self.plain = {s: getattr(self.owner[s], s) for s in self.STAGES}
        self.frames, self.cur = [], []

    def _timed(self, stage):
        import functools

        plain = self.plain[stage]

        # the wrapper carries the plain function's attributes (a kernel
        # wrapper's launch counter counts on it while it is installed)
        @functools.wraps(plain)
        def run(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = plain(*a, **k)
            e1.record()
            self.cur.append((stage, e0, e1))
            if stage == "fxaa":
                self.frames.append(self.cur)
                self.cur = []
            return out
        return run

    def __enter__(self):
        for s in self.STAGES:
            setattr(self.owner[s], s, self._timed(s))
        return self

    def __exit__(self, *exc):
        for s in self.STAGES:
            setattr(self.owner[s], s, self.plain[s])

    def frame(self, i) -> dict:
        """Frame ``i``'s device ms by stage."""
        torch.cuda.synchronize()
        rec = self.frames[i]
        ms = lambda a, b: a.elapsed_time(b)
        of = lambda s: [(e0, e1) for st, e0, e1 in rec if st == s]
        inst = of("svgf")
        (taa0, taa1), (fx0, fx1) = of("taa")[0], of("fxaa")[0]
        return {"svgf_instances": [ms(a, b) for a, b in inst],
                "temporal": sum(ms(a, b) for a, b in of("svgf_temporal")),
                "atrous": sum(ms(a, b) for a, b in of("svgf_atrous")),
                "exposure_tonemap": ms(inst[-1][1], taa0), "taa": ms(taa0, taa1),
                "fxaa": ms(fx0, fx1), "chain": ms(inst[0][0], fx1)}

    def mean(self, lo, hi) -> dict:
        per = [self.frame(i) for i in range(lo, hi)]
        out = {k: float(np.mean([p[k] for p in per])) for k in per[0] if k != "svgf_instances"}
        out["svgf_instances"] = [float(x) for x in np.mean([p["svgf_instances"] for p in per], 0)]
        return out


def split_text(s: dict) -> str:
    inst = " + ".join(f"{x:.2f}" for x in s["svgf_instances"])
    return (f"denoise chain {s['chain']:.2f} ms on the device: SVGF {inst} ms (temporal "
            f"{s['temporal']:.2f}, a-trous {s['atrous']:.2f}), exposure + tonemap "
            f"{s['exposure_tonemap']:.2f}, TAA {s['taa']:.2f}, FXAA {s['fxaa']:.2f}")


def chain_cpu_vs_card(phase, smi):
    """The denoise chain on identical seeded inputs at 256x144 (two depth
    planes, a normal flip, a flat block, motion vectors), on the CPU and
    on the card: three SVGF frames (output and every state field), TAA,
    FXAA and the auto exposure."""
    from merian_quake_tpu_torch.post import exposure, fxaa, svgf, taa

    r = np.random.default_rng(3)
    h, w = 144, 256
    irr = r.gamma(1.0, 0.5, (h, w, 3)).astype(np.float32)
    irr[20:40, 20:40] = 0.5
    mom = (irr.mean(-1) ** 2 * 2.0).astype(np.float32)
    mv = r.normal(0, 1.5, (h, w, 2)).astype(np.float32)
    n = np.zeros((h, w, 3), np.float32)
    n[..., 2] = 1.0
    n[:, w // 2:] = [1.0, 0.0, 0.0]
    n += r.normal(0, 0.05, n.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    z = (np.where(np.arange(w)[None] < w // 3, 50.0, 500.0) * np.ones((h, 1))
         + r.uniform(0, 1, (h, w))).astype(np.float32)
    zg = r.uniform(0, 2, (h, w, 2)).astype(np.float32)
    alb = r.uniform(0, 1, (h, w, 3)).astype(np.float32)
    res = {}
    for dev in ("cpu", "cuda"):
        a = [torch.from_numpy(x).to(dev) for x in (irr, mom, mv, n, z, zg, alb)]
        st = svgf.init_svgf_state(h, w, device=dev)
        for _ in range(3):
            st, out = svgf.svgf(st, *a)
        ldr = out / (1.0 + out)
        t = taa.taa(ldr * 0.9, ldr, a[2])
        res[dev] = (out, t, fxaa.fxaa(t), exposure.auto_exposure(out)[1], st)
    (o_c, t_c, f_c, e_c, s_c), (o_g, t_g, f_g, e_g, s_g) = res["cpu"], res["cuda"]
    close = lambda x, y: bool(torch.allclose(y.cpu(), x, **CHAIN_TOL))
    rel = lambda x, y: float(((y.cpu() - x).abs() / (x.abs() + 1e-6)).max())
    fx = float(((f_g.cpu() - f_c).abs().amax(-1) <= PIX_TOL).float().mean())
    log(f"phase {phase} denoise chain cpu vs cuda on identical 256x144 inputs: svgf max rel "
        f"{rel(o_c, o_g):.3e}, state max rel {max(rel(x, y) for x, y in zip(s_c, s_g)):.3e}, taa "
        f"{rel(t_c, t_g):.3e}, fxaa pixels within {PIX_TOL} {fx:.5f} (bound {FXAA_SHARE}), "
        f"exposure scale {float(e_c):.6f} / {float(e_g):.6f}")
    if not (close(o_c, o_g) and all(close(x, y) for x, y in zip(s_c, s_g)) and close(t_c, t_g)
            and close(e_c, e_g) and fx >= FXAA_SHARE):
        raise AssertionError("the denoise chain differs between the CPU and the card")


def phase23(dev, smi, city_scene, mcpg_city_frames):
    """The denoised main path: city MCPG at 1080p with ``denoise=True``,
    16 frames (3 K1 a frame), the denoise chain's split, a steady frame
    with no synchronizing call; config3's render setup (ReSTIR, 1 spp,
    denoise, cornell_box, 8 frames); cornell_box PT denoised at 64x36 on
    the CPU against the card."""
    from merian_quake_tpu_torch.models.procedural import cornell_box
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import render_frame

    bundle, accel, config = city_scene
    config, mcfg = mcpg_scene_config(config)
    config = config._replace(denoise=True)
    with DenoiseSplit() as split:
        state, out, counts, frame_ms, (live, applied) = mcpg_frames(
            23, "mcpg city denoise", dev, bundle, accel, config, mcfg, 16, (12, 16),
            {"woop_nearest": 3}, smi)
        s = split.mean(12, 16)
    if counts != {**{k: 0 for k in counts}, "woop_nearest": 48}:
        raise AssertionError(f"the denoised city MCPG frames launched {counts}, expected K1 alone")
    for name, x in (("svgf.irr", state.svgf.irr), ("svgf.moments", state.svgf.moments),
                    ("taa_prev", state.taa_prev)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"mcpg city denoise {name} is not finite")
    if float(state.svgf.history_len.max()) != 16.0 or bool(state.accum_irradiance.any()):
        raise AssertionError("the SVGF history does not grow, or the plain accumulators moved")
    steady = float(np.mean(frame_ms[12:16]))
    log(f"phase 23 mcpg city denoise [{smi}]: frames 12-15 {steady:.1f} ms/frame against "
        f"{mcpg_city_frames['ms']:.1f} without denoise (phase 16, same run); {split_text(s)} "
        f"(mean of frames 12-15, CUDA events), {100 * s['chain'] / steady:.1f}% of the frame")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=16), config,
                                  state, mcfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("phase 23 mcpg city denoise frame 16 under torch.cuda.set_sync_debug_mode('error'): no "
        "synchronizing call")

    # config3's render setup (presets.py:98-108), still camera
    box = cornell_box(device=dev)
    b_accel, b_cfg = scene_1080(box, spp=1, integrator="restir", denoise=True)
    rcfg = ReSTIRConfig(spatial_reuse_iterations=2, temporal_bias_correction=1)
    with DenoiseSplit() as rsplit:
        _, _, restir_counts, r_ms, _ = frames_run(
            23, "restir box denoise (config3)", dev, box, b_accel, b_cfg, rcfg, 8, (4, 8),
            {"woop_nearest": 2, "woop_any": 1}, smi, W * H * 3)
        rs = rsplit.mean(4, 8)
    log(f"phase 23 restir box denoise (config3) [{smi}]: {split_text(rs)} (frames 4-7)")

    chain_cpu_vs_card(23, smi)
    small = RenderConfig(width=64, height=36, spp=SPP, max_path_length=MPL, denoise=True)
    cpu_vs_card(23, "box pt denoise", lambda: cornell_box(device="cpu"), small, None, 3, DENOISE_PT,
                report=("hdr",))
    return counts, restir_counts, {"ms": steady, "cold": frame_ms[0], "split": s,
                                   "undenoised_ms": mcpg_city_frames["ms"],
                                   "restir_box_ms": float(np.mean(r_ms[4:8])), "restir_split": rs}


def phase24(dev, smi):
    """The second SVGF: the fogged court, MCPG + VolumeConfig(volume_spp=1),
    denoise, 1080p, 2 spp, 9 frames (config5's render setup, still
    camera), both SVGF instances timed; 64x36 CPU against card."""
    from merian_quake_tpu_torch.models.procedural import outdoor_court
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig

    bundle, accel, config = court(dev, FOG_MU_T)
    config = config._replace(integrator="mcpg", denoise=True)
    mcfg = MCPGConfig(volume=VolumeConfig(volume_spp=1))
    rays = W * H * (1 + SPP * (MPL - 1) + 1)
    with DenoiseSplit() as split:
        state, out, counts, stats = court_frames(24, "court fog mcpg + volume denoise", dev, bundle,
                                                 accel, config, mcfg, 9, (6, 9), rays, smi)
        s = split.mean(6, 9)
    if len(s["svgf_instances"]) != 2 or state.volume_svgf is None:
        raise AssertionError("the volume's SVGF did not run")
    for name, x in (("volume_svgf.irr", state.volume_svgf.irr), ("svgf.irr", state.svgf.irr)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"court fog denoise {name} is not finite")
    log(f"phase 24 court fog mcpg + volume denoise [{smi}]: {split_text(s)} (frames 6-8; the "
        f"second SVGF instance is the volume's), {100 * s['chain'] / stats['ms']:.1f}% of the frame")
    small = RenderConfig(width=64, height=36, spp=1, max_path_length=MPL, integrator="mcpg",
                         denoise=True)
    cpu_vs_card(24, "court fog mcpg + volume denoise", lambda: outdoor_court(FOG_MU_T, device="cpu"),
                small, MCPGConfig(volume=VolumeConfig()), 3, DENOISE_VOLUME, report=("hdr",))
    return counts, {**stats, "split": s}


def phase25(dev, smi, city_scene):
    """SSMM: city at 1080p, 2 spp, 10 frames (1 + spp K1 a frame); the court
    at 1080p, 1 spp, denoise, 8 frames (config4's render setup, still
    camera); cornell_box at 64x36 and 256x8 (tiled buffer order) on the CPU
    against the card; 64 accumulated frames against PT's mean."""
    from merian_quake_tpu_torch.models.procedural import cornell_box
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render import layout
    from merian_quake_tpu_torch.render.ssmm import SSMMConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    bundle, accel, config = city_scene
    scfg = SSMMConfig()
    cfg = config._replace(integrator="ssmm")
    state, out, city_counts, frame_ms, _ = frames_run(
        25, "ssmm city", dev, bundle, accel, cfg, scfg, 10, (4, 10), {"woop_nearest": 1 + SPP}, smi,
        W * H * (1 + SPP))
    live = float((state.ssmm.sum_w > 0).float().mean())
    if not (live > 0.1 and bool(torch.isfinite(state.ssmm.sum_tgt).all())):
        raise AssertionError(f"the SSMM chains did not learn: {live} of the pixels")
    ssmm_ms = float(np.mean(frame_ms[4:10]))

    c_bundle, c_accel, c_cfg = court(dev)
    c_cfg = c_cfg._replace(spp=1, integrator="ssmm", denoise=True)
    with DenoiseSplit() as split:
        _, _, court_counts, stats = court_frames(25, "court ssmm denoise", dev, c_bundle, c_accel,
                                                 c_cfg, scfg, 8, (4, 8), W * H * 2, smi)
        s = split.mean(4, 8)
    log(f"phase 25 ssmm city: chains with sum_w > 0 {live:.4f} of the pixels, frames 4-9 "
        f"{ssmm_ms:.1f} ms/frame; court ssmm denoise [{smi}]: {split_text(s)} (frames 4-7)")

    for w, h in ((64, 36), (256, 8)):
        small = RenderConfig(width=w, height=h, spp=SPP, integrator="ssmm")
        if layout.is_tiled(w, h) != (w == 256):
            raise AssertionError("256x8 is not in tiled buffer order")
        cpu_vs_card(25, "box ssmm", lambda: cornell_box(device="cpu"), small, scfg, 3,
                    SSMM_IRRADIANCE)
    small = RenderConfig(width=64, height=36, spp=SPP, integrator="ssmm", denoise=True)
    cpu_vs_card(25, "box ssmm denoise", lambda: cornell_box(device="cpu"), small, scfg, 3,
                SSMM_IRRADIANCE, report=("ldr", "hdr"))

    # the estimator: 64 accumulated frames of ssmm (2 spp) and of pt (4
    # spp, max path length 2: the one bounce SSMM guides) on the card
    means = {}
    for name, kw in (("ssmm", dict(spp=SPP, integrator="ssmm")), ("pt", dict(spp=4, max_path_length=2))):
        st, _ = render_sequence(cornell_box(device="cpu"), RenderConfig(width=64, height=36, **kw),
                                frames=64, mcpg_config=scfg if name == "ssmm" else None)
        means[name] = float(st.accum_irradiance[..., :3].mean())
    rel = abs(means["ssmm"] - means["pt"]) / means["pt"]
    log(f"phase 25 estimator box 64x36 x64 accumulated frames on the card: mean irradiance ssmm "
        f"{means['ssmm']:.5f}, pt {means['pt']:.5f}, relative difference {rel:.4f} (bound "
        f"{SSMM_ESTIMATOR_REL})")
    if rel > SSMM_ESTIMATOR_REL:
        raise AssertionError("SSMM's estimate and the path tracer's disagree")
    return city_counts, court_counts, {"ms": ssmm_ms, "cold": frame_ms[0], "court": {**stats, "split": s},
                                       "estimator_rel": rel}
