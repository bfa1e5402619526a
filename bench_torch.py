#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port: the guided (MCPG) frame on one GPU.

    python3 bench_torch.py

Prints ONE JSON line in bench.py's shape, {"metric", "value", "unit",
"detail"}, for the same rows as bench.py, all at 1920×1080, 2 spp, max
path length 3, on the first CUDA device:

- the headline: procedural ``city()`` (16,640 triangles), ``MCPGConfig()``;
  ``value`` is the Mrays/s of frames 12-15 (``warm12``), beside frames 2-5
  (cold) and 28-31 (steady);
- ``map_scale``: ``city(n_buildings=28000, seed=11)`` (281,536 triangles,
  the streamed-table trace), ``MCPGConfig()``, frames 2-4 and 6-8;
- ``production_scale``: ``production_config()`` on ``city()``: 33,577,268
  chain states, 4,000,037 light-cache cells, 2 spp volume single
  scattering with distance guiding; frames 2-4 and 6-8.

- ``live_scale`` (bench.py:181-234): the live dungeon, ``make_bigmap()``
  at its defaults (grid 8, 32 monsters, about 290,000 static triangles,
  a dynamic suffix of 4,096), each frame the native game step
  (``LiveGame.step_dynamic``), the dynamic suffix's refresh
  (``refresh_dynamic``) and the MCPG render, with the features the
  entities need forced on (bench.py:198-201); 7 settle frames (frames
  5-7 give the step and refresh ms, host clock, and the render ms, synced),
  then 3 timed frames (host clock, one synchronize at the end, as
  bench.py times them).

Each of the other rows renders two settle frames, then a fresh state
from frame 0, and times windows of frames on the host clock, each ending
in ``torch.cuda.synchronize()``; then the same windows again through the
captured frame (``renderer.compile_frame``: one CUDA graph, warmed up and
captured at frame 0, replayed a frame), whose ms/frame, Mrays/s, capture
seconds and graph pool bytes stand beside the eager ones (``captured_*``
keys). The live loop is not captured (its refresh makes its tables anew
a frame), so ``live_scale`` has no captured numbers. Mrays/s = W·H·(1 + spp·(mpl − 1)) /
frame time, plus W·H·volume_spp for the production row
(bench.py:236-239). bench.py's ``vs_baseline`` and ``vs_prev`` compare
against TPU figures and are not computed. Without a CUDA device the
script fails and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

W, H, SPP, MPL = 1920, 1080, 2, 3
MAP = {"n_buildings": 28000, "seed": 11}
# bench.py's live_scale frames: 7 settle frames (5-7 give the step, refresh
# and render ms), then 3 timed
LIVE_SETTLE, LIVE_TIMED = 7, 3


def phases(bundle, accel, config, mcfg, windows, timed, device, captured=False):
    """Render one sequence and time ``timed`` frames from each window's
    start frame (``windows``: name → start). Eagerly, two settle frames
    run first on their own state; ``captured``: the frames run through
    ``compile_frame``, whose first call warms up and captures. The timed
    sequence starts from an empty state at frame 0. Returns ({name:
    seconds a frame}, peak device bytes), and with ``captured`` also
    {capture seconds, graph pool bytes}."""
    from merian_quake_tpu_torch.renderer import compile_frame, init_state, render_frame

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if captured:
        cf = compile_frame(accel, bundle.atlas, config, init_state(config, mcfg, device=device),
                           mcfg)
        step = lambda st, u: cf(u)
    else:
        step = lambda st, u: render_frame(accel, bundle.atlas, u, config, st, mcfg)
        state = init_state(config, mcfg, device=device)
        for i in range(2):
            state, _ = step(state, bundle.uniforms._replace(frame=1000 + i))
        del state
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = None if captured else init_state(config, mcfg, device=device)
    out, frame = {}, 0
    for name, start in sorted(windows.items(), key=lambda kv: kv[1]):
        while frame < start:
            state, _ = step(state, bundle.uniforms._replace(frame=frame))
            frame += 1
        sync()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, outputs = step(state, bundle.uniforms._replace(frame=frame))
            frame += 1
        sync()
        out[name] = (time.perf_counter() - t0) / timed
        if not bool(torch.isfinite(outputs["ldr"]).all()):
            raise RuntimeError(f"frame {frame - 1}: the image is not finite")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if not captured:
        return out, peak
    cap = cf.captured
    return out, peak, {"capture_s": None if cap is None else round(cap.capture_seconds, 3),
                       "graph_pool_bytes": None if cap is None else cap.pool_bytes}


def scene(device, **kw):
    """A city bundle, its accel and its 1080p MCPG config."""
    from merian_quake_tpu_torch.accel.build import build_accel, scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig

    bundle = city(device=device, **kw)
    accel = build_accel(bundle.scene, bundle.atlas)
    config = RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL, integrator="mcpg",
                          features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas))
    return bundle, accel, config


def live_scale(device, mcfg):
    """bench.py's ``live_scale`` row on ``device``: returns its numbers."""
    from merian_quake_tpu_torch.accel.build import build_accel_live, refresh_dynamic
    from merian_quake_tpu_torch.cli import live_features
    from merian_quake_tpu_torch.game.bigmap import make_bigmap
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    live, _ = make_bigmap(device=device)
    la = build_accel_live(live.gs.static_bundle, dyn_cap=live.gs.dynamic_capacity, device=device)
    atlas = live.gs.static_bundle.atlas
    cfg = RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL, integrator="mcpg",
                       features=live_features(live.gs.static_bundle))
    state = init_state(cfg, mcfg, device=device)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    step = refresh = render = 0.0
    steady = range(4, 7)  # frames 5-7
    for i in range(LIVE_SETTLE):
        t0 = time.perf_counter()
        dyn, uniforms = live.step_dynamic(dt=1.0 / 30.0, forward=120.0, yaw=25.0 + 2.0 * i)
        t1 = time.perf_counter()
        la = refresh_dynamic(la, dyn)
        t2 = time.perf_counter()
        state, out = render_frame(la.accel, atlas, uniforms, cfg, state, mcfg)
        sync()
        if i in steady:
            step, refresh = step + t1 - t0, refresh + t2 - t1
            render += time.perf_counter() - t2
    t0 = time.perf_counter()
    for i in range(LIVE_TIMED):
        dyn, uniforms = live.step_dynamic(dt=1.0 / 30.0, forward=120.0, yaw=40.0 + 2.0 * i)
        la = refresh_dynamic(la, dyn)
        state, out = render_frame(la.accel, atlas, uniforms, cfg, state, mcfg)
    sync()
    frame = (time.perf_counter() - t0) / LIVE_TIMED
    if not bool(torch.isfinite(out["ldr"]).all()) or int(dyn["valid"].sum()) == 0:
        raise RuntimeError("live_scale: the image is not finite or no entity is drawn")
    n = len(steady)
    return {"live_ms_per_frame": round(frame * 1e3, 2), "step_ms": round(step / n * 1e3, 3),
            "refresh_ms": round(refresh / n * 1e3, 3), "render_ms": round(render / n * 1e3, 2),
            "h2d_bytes_per_frame": refresh_dynamic.h2d_bytes,
            "static_triangles": la.n_static, "dynamic_capacity": la.dyn_cap,
            "dynamic_triangles": int(dyn["valid"].sum()),
            "peak_device_bytes": torch.cuda.max_memory_allocated() if cuda else None}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch: torch.cuda.is_available() is False")
    from merian_quake_tpu_torch import kernels
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.mcpg.config import production_config

    device = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kernels.build_libraries(*kernels.KERNELS)
    rays = W * H * (1 + SPP * (MPL - 1))
    rate = lambda sec, r=rays: round(r / sec / 1e6, 2)

    bundle, accel, config = scene(device)
    mcfg = MCPGConfig()
    head_w = {"cold": 2, "warm12": 12, "steady": 28}
    head, head_peak = phases(bundle, accel, config, mcfg, head_w, 4, device)
    head_c = phases(bundle, accel, config, mcfg, head_w, 4, device, captured=True)
    prod = production_config()
    rays_prod = rays + W * H * prod.volume.volume_spp
    pr, prod_peak = phases(bundle, accel, config, prod, {"cold": 2, "warm6": 6}, 3, device)
    pr_c = phases(bundle, accel, config, prod, {"cold": 2, "warm6": 6}, 3, device, captured=True)
    del bundle, accel
    m_bundle, m_accel, m_config = scene(device, **MAP)
    mp, map_peak = phases(m_bundle, m_accel, m_config, mcfg, {"cold": 2, "warm6": 6}, 3, device)
    mp_c = phases(m_bundle, m_accel, m_config, mcfg, {"cold": 2, "warm6": 6}, 3, device,
                  captured=True)
    n_map = int(m_accel.scene.num_tris)
    del m_bundle, m_accel
    live = live_scale(device, mcfg)

    def row(t, key, r=rays, cap=None):
        out = {"cold_frame_ms": round(t["cold"] * 1e3, 2), "cold_mrays_per_s": rate(t["cold"], r),
               "frame_ms": round(t[key] * 1e3, 2), "mrays_per_s": rate(t[key], r)}
        if cap is not None:  # the captured frame's numbers beside the eager ones
            (tc, peak, extra) = cap
            out.update({"captured_cold_frame_ms": round(tc["cold"] * 1e3, 2),
                        "captured_frame_ms": round(tc[key] * 1e3, 2),
                        "captured_mrays_per_s": rate(tc[key], r),
                        "captured_peak_device_bytes": peak,
                        **{f"captured_{k}": v for k, v in extra.items()}})
        return out
    print(json.dumps({
        "metric": "mcpg_ray_throughput_1080p_17k_tris_single_gpu",
        "value": rate(head["warm12"]),
        "unit": "Mrays/s",
        "detail": {
            **row(head, "warm12", cap=head_c),
            "steady_frame_ms": round(head["steady"] * 1e3, 2),
            "steady_mrays_per_s": rate(head["steady"]),
            "captured_steady_frame_ms": round(head_c[0]["steady"] * 1e3, 2),
            "peak_device_bytes": head_peak,
            "resolution": f"{W}x{H}", "spp": SPP, "max_path_length": MPL,
            "integrator": "mcpg", "scene": "procedural city (16,640 tris, sky+sun+emissives)",
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "map_scale": {**row(mp, "warm6", cap=mp_c), "triangles": n_map,
                          "peak_device_bytes": map_peak},
            "live_scale": {**live, "mrays_per_s": rate(live["live_ms_per_frame"] / 1e3)},
            "production_scale": {**row(pr, "warm6", rays_prod, cap=pr_c),
                                 "rays_per_frame": rays_prod,
                                 "mc_states": prod.mc_total_size, "light_cache": prod.lc_size,
                                 "volume_spp": prod.volume.volume_spp,
                                 "dist_guide_p": prod.volume.dist_guide_p,
                                 "peak_device_bytes": prod_peak},
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
