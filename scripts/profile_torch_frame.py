#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's 1080p frame.

    python3 scripts/profile_torch_frame.py [--integrator pt|restir|mcpg] [--frames 2] [--out profiling]
        [--n-buildings N --seed S] [--scene court [--fog MU]] [--production]

Needs one CUDA device. On procedural ``city`` (its defaults: 16,640
triangles; ``--n-buildings 28000 --seed 11`` is the map scene, 281,536
triangles, traced by K3) or ``--scene court`` (``outdoor_court``: 20
triangles, two alpha-tested grates; ``--fog MU`` its fog's extinction) at
1920×1080 with chip_smoke.py's configurations (``pt``: 2 spp, max path
length 3; ``restir``: ``ReSTIRConfig()``; ``mcpg``: 2 spp, max path
length 3, ``MCPGConfig()``, with ``VolumeConfig()`` when ``--fog`` is
given, ``production_config()`` with ``--production``; 12 warm-up frames
so that the chains have learned) it measures:

1. host ms per stage of a steady frame (gbuffer, the integrator, and the
   rest of the frame = accumulate, exposure, tonemap), each stage ended
   by a device sync inside one frame; for ``restir`` also the share of
   its traces (``trace_ray`` of the generate pass, ``trace_visibility``
   of the shade pass); for ``mcpg`` the stages are gbuffer,
   pack_tables, surface, compact_queues, apply_updates_compact and the
   rest, and with the volume pass volume, compact_dist and
   apply_dist_updates;
2. a ``torch.profiler`` trace of ``--frames`` steady frames: device time
   against the host clock (the device's busy share), and device time by
   op, the trace kernels (``woop_nearest_kernel``, ``woop_stream_kernel``
   and the others) among them;
3. the coherence sort of bounce rays (``woop.intersect_woop(...,
   sort_rays=True)``: key, sort, gathers, scatter back) against none, on
   one 2,073,600-ray bounce population: the whole trace and its kernel
   alone (K1, or K3 above 65,536 triangles),
   timed with CUDA events in turns (sort, none, none, sort) (``pt``
   only); then the whole frame with the integrator's bounce traces
   sorted and as they lie (the frame's own way), in the same turns, 5
   steady frames a turn (``pt`` and ``mcpg``).

Prints one line per measurement and the card's name and power limit;
the full op table goes to ``<out>/profile_frame_<integrator>[_<n>].txt``
(``_<n>`` with ``--n-buildings``, ``_court``, ``_court_fog`` or
``_production``).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (primary/bounce ray populations, cuda_time)
from merian_quake_tpu_torch.accel import build_accel, woop  # noqa: E402
from merian_quake_tpu_torch.accel.build import scene_features  # noqa: E402
from merian_quake_tpu_torch.models.procedural import city, outdoor_court  # noqa: E402
from merian_quake_tpu_torch.models.types import RenderConfig  # noqa: E402
from merian_quake_tpu_torch import renderer  # noqa: E402
from merian_quake_tpu_torch.render import pt as pt_mod  # noqa: E402
from merian_quake_tpu_torch.render import restir as restir_pkg  # noqa: E402
from merian_quake_tpu_torch.render.mcpg import MCPGConfig  # noqa: E402
from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig  # noqa: E402
from merian_quake_tpu_torch.render.mcpg import surface as surface_mod  # noqa: E402
from merian_quake_tpu_torch.render.mcpg import updates as updates_mod  # noqa: E402
from merian_quake_tpu_torch.render.mcpg import volume as volume_mod  # noqa: E402
from merian_quake_tpu_torch.render.mcpg.config import production_config  # noqa: E402
from merian_quake_tpu_torch.render.restir import restir as restir_mod  # noqa: E402
from merian_quake_tpu_torch.renderer import init_state, render_frame  # noqa: E402

W, H, SPP, MPL = chip_smoke.W, chip_smoke.H, chip_smoke.SPP, chip_smoke.MPL


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--integrator", choices=("pt", "restir", "mcpg"), default="pt")
    ap.add_argument("--frames", type=int, default=2, help="frames in the profile")
    ap.add_argument("--out", default=os.path.join(ROOT, "profiling"),
                    help="directory for profile_frame_<integrator>.txt")
    ap.add_argument("--n-buildings", type=int, default=None,
                    help="city's building count (default: its own; 28000 is the map scene)")
    ap.add_argument("--seed", type=int, default=None, help="city's seed (default: its own)")
    ap.add_argument("--scene", choices=("city", "court"), default="city")
    ap.add_argument("--fog", type=float, default=None,
                    help="the court's fog extinction; with mcpg, the volume pass runs")
    ap.add_argument("--production", action="store_true",
                    help="mcpg with production_config() (33.6M chain states, 2 volume spp)")
    args = ap.parse_args()
    if args.production:
        args.integrator = "mcpg"
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frame: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    scene_kw = {k: v for k, v in (("n_buildings", args.n_buildings), ("seed", args.seed))
                if v is not None}
    if args.scene == "court":
        bundle = outdoor_court(args.fog or 0.0, device=dev)
        scene_kw = {"fog_mu_t": args.fog or 0.0}
    else:
        bundle = city(**scene_kw, device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    kernel = woop.woop_stream if woop.streamed(accel.woop_w) else woop.woop_nearest
    print(f"scene {args.scene}({scene_kw or 'defaults'}): {bundle.scene.num_tris} triangles, "
          f"traced by {kernel.__name__}", flush=True)
    tag = f"_{args.n_buildings}" if args.n_buildings is not None else ""
    tag += "_court" if args.scene == "court" else ""
    tag += "_fog" if args.fog else ""
    tag += "_production" if args.production else ""
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    config = RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL, features=feats,
                          integrator=args.integrator)
    mcfg = MCPGConfig(volume=VolumeConfig()) if args.fog else MCPGConfig()
    mcfg = production_config() if args.production else mcfg
    rcfg = {"restir": restir_pkg.ReSTIRConfig(), "mcpg": mcfg}.get(args.integrator)
    state = init_state(config, rcfg, device=dev)
    u = bundle.uniforms
    frame = 0

    def step():
        nonlocal state, frame
        state, _ = render_frame(accel, bundle.atlas, u._replace(frame=frame), config, state, rcfg)
        frame += 1

    # warm up: kernel build, allocator, first launches; the chains' learning
    for _ in range(12 if args.integrator == "mcpg" else 2):
        step()

    # ---- 1: host ms per stage ----
    # (module, attribute) of each timed stage; the integrator's traces are
    # timed inside the integrator stage and are part of it
    top = {"gbuffer": (renderer, "render_gbuffer")}
    inner = {}
    if args.integrator == "pt":
        top["pt"] = (renderer, "render_pt")
    elif args.integrator == "mcpg":
        top.update({"pack_tables": (surface_mod, "pack_tables"),
                    "surface": (surface_mod, "render_mcpg_surface")})
        if rcfg.volume is not None:
            top.update({"volume": (volume_mod, "render_volume"),
                        "compact_dist": (volume_mod, "compact_dist"),
                        "apply_dist_updates": (volume_mod, "apply_dist_updates")})
        top.update({"compact_queues": (updates_mod, "compact_queues"),
                    "apply_updates_compact": (updates_mod, "apply_updates_compact")})
    else:
        top["restir"] = (restir_pkg, "render_restir")
        inner = {"restir trace_ray": (restir_mod, "trace_ray"),
                 "restir trace_visibility": (restir_mod, "trace_visibility")}
    stage_fns = {k: (mod, name, getattr(mod, name)) for k, (mod, name) in {**top, **inner}.items()}
    stages = {k: [] for k in stage_fns}
    stages["rest"] = []

    def timed(key, fn):
        def run(*a, **k):
            out, ms = host_ms(lambda: fn(*a, **k))
            stages[key].append(ms)
            return out
        return run

    try:
        for key, (mod, name, fn) in stage_fns.items():
            setattr(mod, name, timed(key, fn))
        for _ in range(3):
            n_inner = {k: len(stages[k]) for k in inner}
            _, f_ms = host_ms(step)
            for k in inner:  # one entry per frame: the sum of its calls
                stages[k][n_inner[k]:] = [sum(stages[k][n_inner[k]:])]
            stages["rest"].append(f_ms - sum(stages[k][-1] for k in top))
    finally:
        for mod, name, fn in stage_fns.values():
            setattr(mod, name, fn)
    print(f"stages {args.integrator} [{smi}]: " + ", ".join(
        f"{k} {np.mean(v):.2f} ms" for k, v in stages.items()) + " (host clock, mean of 3)",
        flush=True)

    # ---- 2: profiler ----
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    rows = sorted(avgs, key=dev_us, reverse=True)
    # device-side events (kernels, copies) carry the time once; the ops
    # that launched them repeat it as their self device time
    on_dev = [e for e in rows if e.device_type.name != "CPU"]
    ops = [e for e in rows if e.device_type.name == "CPU" and dev_us(e) > 0]
    total_ms = sum(dev_us(e) for e in on_dev) / 1e3
    print(f"profile {args.integrator} [{smi}]: {args.frames} frames, wall {wall_ms:.1f} ms, device "
          f"{total_ms:.1f} ms, busy {total_ms / wall_ms:.3f}, "
          f"{sum(e.count for e in on_dev)} device kernels/copies", flush=True)
    for kind, sel in (("op", ops[:12]), ("kernel", on_dev[:8])):
        for e in sel:
            print(f"  {kind:6s} {dev_us(e) / 1e3:9.2f} ms {dev_us(e) / 1e3 / total_ms:6.1%} "
                  f"x{e.count:<6d} {e.key[:90]}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_frame_{args.integrator}{tag}.txt"), "w") as f:
        f.write(f"{smi}\n")
        f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=80))

    if args.integrator == "restir":
        return 0

    # ---- 3: bounce sort vs none ----
    if args.integrator == "pt":
        sort_one_trace(bundle, accel, config, dev, kernel, smi)

    # the whole frame: the integrator's bounce traces sorted, and as they lie
    frames_ms = {}
    mod = pt_mod if args.integrator == "pt" else surface_mod
    plain_trace = mod.trace_ray
    try:
        for label in ("sort", "none", "none", "sort"):
            if label == "sort":
                mod.trace_ray = lambda *a, **k: plain_trace(*a, **{**k, "sort_rays": True})
            else:
                mod.trace_ray = plain_trace
            step()
            ms = [host_ms(step)[1] for _ in range(5)]
            frames_ms.setdefault(label, []).append(float(np.mean(ms)))
    finally:
        mod.trace_ray = plain_trace
    print(f"sort frame {args.integrator} [{smi}]: " + "; ".join(
        f"{k} {'/'.join(f'{x:.2f}' for x in v)} ms/frame" for k, v in frames_ms.items())
        + " (host clock, mean of 5 steady frames per turn)", flush=True)
    return 0


def sort_one_trace(bundle, accel, config, dev, kernel, smi):
    """One 2,073,600-ray bounce population traced with the coherence sort
    and without: the same hits, the whole trace and its kernel timed."""
    bo, bd, bt = chip_smoke.bounce_rays(bundle, accel, config, dev)
    perm = woop.sort_perm(accel, bo, bd, bt)
    trace = lambda s: woop.intersect_woop(accel, bo, bd, 0.0, bt, sort_rays=s)
    hr_s, hr_n = trace(True), trace(False)
    if not (torch.equal(hr_s.tri, hr_n.tri) and torch.equal(hr_s.t, hr_n.t)):
        raise AssertionError("the bounce trace gives other hits without the sort")
    k1_args = {
        "sort": woop.k1_inputs(accel, bo[perm], bd[perm], torch.zeros_like(bt), bt[perm]),
        "none": woop.k1_inputs(accel, bo, bd, torch.zeros_like(bt), bt),
    }
    times = {}
    for label in ("sort", "none", "none", "sort"):
        whole = chip_smoke.cuda_time(lambda: trace(label == "sort"), 10)
        k1 = chip_smoke.cuda_time(lambda: kernel(*k1_args[label]), 10)
        times.setdefault(label, []).append((whole, k1))
    print(f"sort bounce {W * H} rays [{smi}]: " + "; ".join(
        f"{k}: trace {'/'.join(f'{a:.3f}' for a, _ in v)} ms, "
        f"{kernel.__name__} {'/'.join(f'{b:.3f}' for _, b in v)} ms" for k, v in times.items()),
        flush=True)


if __name__ == "__main__":
    sys.exit(main())
