"""The frame captured in one CUDA graph against eager on six paths, and
one dead round of the round loop (38)."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .common import (
    FOG_MU_T, MPL, PROFILE_MS, cuda_time, differing_leaves, launches, log, profiled,
    reset_launches, scene_1080,
)
from .fixtures import court, primary_rays


# phase 38: frames captured in a CUDA graph (renderer.compile_frame,
# Graph.compile): frame 0 (the warm-up, the capture and the first replay)
# and 8 replays, each held bit for bit against eager frame_core / run
CAPTURE_FRAMES = 9
# the trace kernels a captured frame launches
GRAPH_KERNELS = ("woop_nearest", "woop_any", "woop_stream", "woop_stream_any",
                 "woop_nearest_alpha", "woop_stream_alpha")


def captured_run(path, smi, captured, eager, state0, uniforms, captured_step, strip=lambda o: o,
                 want=None):
    """A captured path against its eager frames. ``captured(state, u)`` and
    ``eager(state, u)`` render one frame; ``captured_step()`` is the
    capture.CapturedStep after the first call; ``strip`` drops from the
    outputs what the two forms hold in other types (a graph's ``$frame``
    inputs). Frame 0's captured call warms up, captures and replays, with
    the launch counts set to 0 just before and read just after (the warm-up
    frames and the capture: WARMUP_STEPS + 1 frames' launches); then frames
    0-8, each captured state and output against eager frame_core (or run)
    from the same state, bit for bit. ``want``: the trace kernels a
    captured frame must launch. Returns (the path's launches, its stats)."""
    from merian_quake_tpu_torch.capture import WARMUP_STEPS, tree_map

    clone = lambda x: tree_map(torch.clone, x)
    path_t0 = time.perf_counter()
    reset_launches()
    ref_in = clone(state0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, out = captured(state0, uniforms._replace(frame=0))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launches()
    cap = captured_step()
    in_graph = {k: v // (WARMUP_STEPS + 1) for k, v in counts.items() if k in GRAPH_KERNELS and v}
    if any(v % (WARMUP_STEPS + 1) for v in counts.values()) or (want and in_graph != want):
        raise AssertionError(f"phase 38 {path}: launches {counts} over the warm-up and the capture "
                             f"are not {WARMUP_STEPS + 1} frames' {want}")
    eager_ms, cap_ms, eager_launches = [], [], []
    for i in range(CAPTURE_FRAMES):
        u = uniforms._replace(frame=i)
        if i:
            ref_in = clone(st)
        torch.cuda.synchronize()
        before = launches()
        t0 = time.perf_counter()
        ref_st, ref_out = eager(ref_in, u)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        eager_launches.append({k: v - before[k] for k, v in launches().items()
                               if k in GRAPH_KERNELS and v - before[k]})
        if i:
            t0 = time.perf_counter()
            st, out = captured(st, u)
            torch.cuda.synchronize()
            cap_ms.append((time.perf_counter() - t0) * 1e3)
        bad_state, bad_out = differing_leaves(st, ref_st), differing_leaves(strip(out), strip(ref_out))
        if bad_state or bad_out:
            raise AssertionError(f"phase 38 {path} frame {i}: the captured frame differs from the "
                                 f"eager one in state leaves {bad_state}, output leaves {bad_out}")
        del ref_in, ref_st, ref_out
    if not bool(torch.isfinite(out["ldr"] if "ldr" in out else out[("hud", "out")]).all()):
        raise AssertionError(f"phase 38 {path}: the image is not finite")
    # the device's busy share on the profiler: eager frames and replays over
    # at least PROFILE_MS each (one 1080p frame; its processing of a frame's
    # kernels takes seconds), so that a short frame's window is not the
    # profiler's own start and flush
    fixed = clone(st)
    u = uniforms._replace(frame=CAPTURE_FRAMES)
    t0 = time.perf_counter()
    frames_for = lambda ms: max(1, math.ceil(PROFILE_MS / np.mean(ms[1:])))
    e_dev, e_wall, e_busy = profiled(lambda: eager(fixed, u), frames_for(eager_ms))
    c_dev, c_wall, c_busy = profiled(lambda: captured(st, u), frames_for(cap_ms))
    profile_s = time.perf_counter() - t0
    stats = {"eager_ms": float(np.mean(eager_ms[2:])), "captured_ms": float(np.mean(cap_ms[1:])),
             "first_call_s": first_s, "capture_s": cap.capture_seconds,
             "graph_pool_bytes": cap.pool_bytes, "replays": len(cap_ms) + 1,
             "eager_busy": e_busy, "captured_busy": c_busy, "eager_device_ms": e_dev,
             "captured_device_ms": c_dev, "launches_in_graph": in_graph,
             "eager_launches_per_frame": eager_launches[-1]}
    log(f"phase 38 {path} [{smi}]: eager {stats['eager_ms']:.2f} ms/frame (frames 2-8, busy "
        f"{e_busy:.3f}, device {e_dev:.2f} ms), captured {stats['captured_ms']:.2f} ms/frame "
        f"(replays 2-8, busy {c_busy:.3f}, device {c_dev:.2f} ms); capture {cap.capture_seconds:.3f} s "
        f"(first call with the {WARMUP_STEPS} warm-up frames {first_s:.2f} s); graph pool "
        f"{cap.pool_bytes} bytes; launches in the graph {in_graph} (eager frame "
        f"{eager_launches[-1]}); {CAPTURE_FRAMES} frames bit-identical to eager "
        f"({time.perf_counter() - path_t0:.1f} s, the profiler {profile_s:.1f} s of it)")
    return counts, stats


def dead_round(dev, bundle, accel, smi):
    """What a round of the round loop (which the list walker's route keeps
    under ``alpha_loop_on_device``) costs once every ray is dead, on the
    fogged court's 2,073,600 primary rays: a dead round (K1 on empty
    intervals plus the round's glue) beside a live first round and K1
    alone on the dead rays; beside them the alpha walk, the whole loop in
    one launch, on the same rays dead and live. CUDA events."""
    import importlib

    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.models import materials

    imod = importlib.import_module("merian_quake_tpu_torch.accel.intersect")
    o, d = primary_rays(bundle, accel, dev)
    n = o.shape[0]
    full = lambda v, dt=torch.float32: torch.full((n,), v, dtype=dt, device=dev)
    t_min, t_max = full(0.0), full(materials.T_MAX)
    result = imod.HitRecord(full(3e38), full(-1, torch.int32), full(0.0), full(0.0))
    rnd = lambda active: imod._alpha_round(accel, bundle.atlas, o, d, active, t_min, t_max, result)
    dead_mask, live_mask = full(False, torch.bool), full(True, torch.bool)
    rnd(dead_mask), rnd(live_mask)
    dead_ms, live_ms = cuda_time(lambda: rnd(dead_mask), 10), cuda_time(lambda: rnd(live_mask), 10)
    args = woop.k1_inputs(accel, o, d, t_min, full(imod._DEAD_T_MAX))
    k1_ms = cuda_time(lambda: woop.woop_nearest(*args), 10)
    tables = woop.alpha_tables(accel, bundle.atlas)
    live_args = woop.k1_inputs(accel, o, d, t_min, t_max)
    walk_dead = cuda_time(lambda: woop.woop_nearest_alpha(*args, tables, n=n), 10)
    walk_live = cuda_time(lambda: woop.woop_nearest_alpha(*live_args, tables, n=n), 10)
    log(f"phase 38 court alpha loop, one round on {n} rays [{smi}]: every ray dead "
        f"{dead_ms:.3f} ms (K1 on the empty intervals alone {k1_ms:.3f}), every ray live "
        f"{live_ms:.3f} ms; the alpha walk (the whole loop) on the same rays dead {walk_dead:.3f} "
        f"ms, live {walk_live:.3f} ms")
    return {"dead_round_ms": dead_ms, "dead_round_k1_ms": k1_ms, "live_round_ms": live_ms,
            "alpha_walk_dead_ms": walk_dead, "alpha_walk_live_ms": walk_live}


def phase38(dev, smi, city_scene, map_scene):
    """Captured frames (renderer.compile_frame; Graph.compile for the
    flagship graph): city MCPG (the main path), city ReSTIR (K2), denoised
    city MCPG, map MCPG (K3), config1's small PT frame, the fogged court's
    MCPG + volume (the alpha walk: one launch a trace) and the flagship
    graph on the fogged court, each bit for bit against eager for 9
    frames; then a dead round's cost in the round loop beside the alpha
    walk's."""
    from merian_quake_tpu_torch.graph import Graph
    from merian_quake_tpu_torch.graph.nodes import GraphContext, flagship_graph_config
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import compile_frame, frame_core, init_state

    bundle, accel, config = city_scene
    m_bundle, m_accel, m_config = map_scene

    def frame_path(path, b, acc, cfg, icfg, want):
        state0 = init_state(cfg, icfg, device=dev)
        cf = compile_frame(acc, b.atlas, cfg, state0, icfg)
        return captured_run(
            path, smi, lambda st, u: cf(u),
            lambda st, u: frame_core(acc, b.atlas, u, cfg, st, mcpg_config=icfg),
            state0, b.uniforms, lambda: cf.captured, want=want)

    paths, stats = {}, {}
    k1 = {"woop_nearest": 3}
    for path, b, acc, cfg, icfg, want in (
            ("mcpg", bundle, accel, config._replace(integrator="mcpg"), MCPGConfig(), k1),
            ("restir", bundle, accel, config._replace(integrator="restir"), ReSTIRConfig(),
             {"woop_nearest": 2, "woop_any": 1}),
            ("mcpg_denoise", bundle, accel, config._replace(integrator="mcpg", denoise=True),
             MCPGConfig(), k1),
            ("mcpg_map", m_bundle, m_accel, m_config._replace(integrator="mcpg"), MCPGConfig(),
             {"woop_stream": 3})):
        paths[f"{path}_captured"], stats[path] = frame_path(path, b, acc, cfg, icfg, want)
    # a small frame (config1's: the box, PT, 1 spp, 640x360), launch-bound
    # when eager
    from merian_quake_tpu_torch.models.procedural import cornell_box

    box = cornell_box(device=dev)
    b_accel, b_cfg = scene_1080(box, spp=1, max_path_length=MPL)
    paths["pt_box_640x360_captured"], stats["pt_box_640x360"] = frame_path(
        "pt_box_640x360", box, b_accel, b_cfg._replace(width=640, height=360), None,
        {"woop_nearest": 1 + (MPL - 1)})
    # the fogged court's 3 surface traces and 1 volume sample a frame, each
    # one alpha walk
    c_bundle, c_accel, c_cfg = court(dev, FOG_MU_T)
    mcfg = MCPGConfig(volume=VolumeConfig())
    walks = {"woop_nearest_alpha": 3 + mcfg.volume.volume_spp}
    paths["mcpg_court_volume_captured"], stats["mcpg_court_volume"] = frame_path(
        "mcpg_court_volume", c_bundle, c_accel, c_cfg._replace(integrator="mcpg"), mcfg, walks)

    g = Graph.from_config(flagship_graph_config(), GraphContext(
        c_accel, c_bundle.atlas, c_cfg._replace(integrator="mcpg", denoise=True),
        mcpg_config=MCPGConfig(volume=VolumeConfig(volume_spp=1)), device=dev))
    step = g.compile()
    frame_in = lambda u: {"uniforms": u}
    no_inputs = lambda o: {k: v for k, v in o.items() if k[0] != "$frame"}
    paths["graph_flagship_court_captured"], stats["graph_flagship_court"] = captured_run(
        "graph_flagship_court", smi, lambda st, u: step(st, frame_in(u)),
        lambda st, u: g.run(st, frame_in(u)), g.init_state(), c_bundle.uniforms,
        lambda: step.captured, strip=no_inputs, want={"woop_nearest_alpha": 4})
    stats["court_dead_round"] = dead_round(dev, c_bundle, c_accel, smi)
    return paths, stats
