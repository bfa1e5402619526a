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

Each row renders two settle frames, then a fresh state from frame 0, and
times windows of frames on the host clock, each ending in
``torch.cuda.synchronize()``. Mrays/s = W·H·(1 + spp·(mpl − 1)) / frame
time, plus W·H·volume_spp for the production row (bench.py:236-239).
bench.py's ``live_scale`` row waits for the port's live game loop
(ROADMAP.md queue 1, item 3); its ``vs_baseline`` and ``vs_prev`` compare
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


def phases(bundle, accel, config, mcfg, windows, timed, device):
    """Render one sequence and time ``timed`` frames from each window's
    start frame (``windows``: name → start). Two settle frames run first
    on their own state; the timed sequence starts from an empty state at
    frame 0. Returns ({name: seconds a frame}, peak device bytes)."""
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    state = init_state(config, mcfg, device=device)
    for i in range(2):
        state, _ = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=1000 + i),
                                config, state, mcfg)
    del state
    sync()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = init_state(config, mcfg, device=device)
    out, frame = {}, 0
    for name, start in sorted(windows.items(), key=lambda kv: kv[1]):
        while frame < start:
            state, _ = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=frame),
                                    config, state, mcfg)
            frame += 1
        sync()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, outputs = render_frame(accel, bundle.atlas,
                                          bundle.uniforms._replace(frame=frame), config, state,
                                          mcfg)
            frame += 1
        sync()
        out[name] = (time.perf_counter() - t0) / timed
        if not bool(torch.isfinite(outputs["ldr"]).all()):
            raise RuntimeError(f"frame {frame - 1}: the image is not finite")
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else None
    return out, peak


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
    head, head_peak = phases(bundle, accel, config, mcfg, {"cold": 2, "warm12": 12, "steady": 28},
                             4, device)
    prod = production_config()
    rays_prod = rays + W * H * prod.volume.volume_spp
    pr, prod_peak = phases(bundle, accel, config, prod, {"cold": 2, "warm6": 6}, 3, device)
    del bundle, accel
    m_bundle, m_accel, m_config = scene(device, **MAP)
    mp, map_peak = phases(m_bundle, m_accel, m_config, mcfg, {"cold": 2, "warm6": 6}, 3, device)

    row = lambda t, key, r=rays: {"cold_frame_ms": round(t["cold"] * 1e3, 2),
                                  "cold_mrays_per_s": rate(t["cold"], r),
                                  "frame_ms": round(t[key] * 1e3, 2),
                                  "mrays_per_s": rate(t[key], r)}
    print(json.dumps({
        "metric": "mcpg_ray_throughput_1080p_17k_tris_single_gpu",
        "value": rate(head["warm12"]),
        "unit": "Mrays/s",
        "detail": {
            **row(head, "warm12"),
            "steady_frame_ms": round(head["steady"] * 1e3, 2),
            "steady_mrays_per_s": rate(head["steady"]),
            "peak_device_bytes": head_peak,
            "resolution": f"{W}x{H}", "spp": SPP, "max_path_length": MPL,
            "integrator": "mcpg", "scene": "procedural city (16,640 tris, sky+sun+emissives)",
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "map_scale": {**row(mp, "warm6"), "triangles": int(m_accel.scene.num_tris),
                          "peak_device_bytes": map_peak},
            "production_scale": {**row(pr, "warm6", rays_prod), "rays_per_frame": rays_prod,
                                 "mc_states": prod.mc_total_size, "light_cache": prod.lc_size,
                                 "volume_spp": prod.volume.volume_spp,
                                 "dist_guide_p": prod.volume.dist_guide_p,
                                 "peak_device_bytes": prod_peak},
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
