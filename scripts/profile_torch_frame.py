#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's 1080p frame.

    python3 scripts/profile_torch_frame.py [--integrator pt|restir|mcpg] [--frames 4] [--out profiling]
        [--n-buildings N --seed S] [--scene court [--fog MU]] [--production] [--cost ROUNDS]
    python3 scripts/profile_torch_frame.py --workload <config>.<mix> [--seed N] [--frames 4] [--cost ROUNDS]

Needs one CUDA device. On procedural ``city`` (its defaults: 16,640
triangles; ``--n-buildings 28000 --seed 11`` is the map scene, 281,536
triangles, traced by K3) or ``--scene court`` (``outdoor_court``: 20
triangles, two alpha-tested grates; ``--fog MU`` its fog's extinction) at
1920×1080 with chip_smoke's configurations (``pt``: 2 spp, max path
length 3; ``restir``: ``ReSTIRConfig()``; ``mcpg``: 2 spp, max path
length 3, ``MCPGConfig()``, with ``VolumeConfig()`` when ``--fog`` is
given, ``production_config()`` with ``--production``; 12 warm-up frames
so that the chains have learned), or on a cell of the benchmark
(``--workload``: its configuration and traffic as ``quakebench`` sets
them up, live game step and refresh included, ``--seed`` its seed;
its settle frames and 8 more as warm-up), it measures:

1. the stage table of the compiled frame (renderer.compile_frame: one
   CUDA graph a frame) over ``--frames`` steady frames under a
   ``torch.profiler`` trace: each span the port's tracer recorded
   (utils/profiler.py: the live game step and refresh on the host, the
   replay's lead, the graph's stages from their events, their children),
   its time a frame (the device's where the span has events, else the
   host's), its busy time (the union of the device operations inside its
   interval, the interval placed on the profiler's clock through the
   frame's first span) and its idle; then the device time from each
   replay call to its graph's end against the lead and the top-level
   stages that tile it, and the tracer's counters a frame;
2. from the same trace, device time against the host clock (the device's
   busy share), and device time by op, the trace kernels
   (``woop_nearest_kernel``, ``woop_stream_kernel`` and the others) among
   them;
3. with ``--cost ROUNDS``: the host clock a frame with the tracer
   recording (an installed ``Profiler(enabled=True)``, no torch.profiler)
   and not, in turns (off, on, on, off), 8 frames a turn;
4. the coherence sort of bounce rays (``woop.intersect_woop(...,
   sort_rays=True)``: key, sort, gathers, scatter back) against none, on
   one 2,073,600-ray bounce population: the whole trace and its kernel
   alone (K1, or K3 above 65,536 triangles),
   timed with CUDA events in turns (sort, none, none, sort) (``pt``
   only); then the whole eager frame with the integrator's bounce traces
   sorted and as they lie (the frame's own way), in the same turns, 5
   steady frames a turn (``pt`` and ``mcpg``; not with ``--workload``).

Prints one line per measurement and the card's name and power limit;
the full op table goes to ``<out>/profile_frame_<integrator>[_<n>].txt``
(``_<n>`` with ``--n-buildings``, ``_court``, ``_court_fog`` or
``_production``; ``profile_frame_<cell>.txt`` with ``--workload``).
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import common, fixtures  # noqa: E402  (bounce rays, cuda_time)
from merian_quake_tpu_torch.accel import build_accel, woop  # noqa: E402
from merian_quake_tpu_torch.accel.build import scene_features  # noqa: E402
from merian_quake_tpu_torch.models.procedural import city, outdoor_court  # noqa: E402
from merian_quake_tpu_torch.models.types import RenderConfig  # noqa: E402
from merian_quake_tpu_torch.render import pt as pt_mod  # noqa: E402
from merian_quake_tpu_torch.render import restir as restir_pkg  # noqa: E402
from merian_quake_tpu_torch.render.mcpg import MCPGConfig  # noqa: E402
from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig  # noqa: E402
from merian_quake_tpu_torch.render.mcpg import surface as surface_mod  # noqa: E402
from merian_quake_tpu_torch.render.mcpg.config import production_config  # noqa: E402
from merian_quake_tpu_torch.renderer import compile_frame, init_state, render_frame  # noqa: E402
from merian_quake_tpu_torch.utils import profiler  # noqa: E402
from quakebench import devtrace  # noqa: E402  (the profiler's device operations)

W, H, SPP, MPL = common.W, common.H, common.SPP, common.MPL


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def host_ranges(prof, names) -> dict:
    """{name: [start_s, ...]} of the tracer's ``mq.<name>`` host ranges in
    ``prof``, on the profiler's clock, in order."""
    from torch.autograd import DeviceType

    out = {n: [] for n in names}
    for e in prof.profiler.kineto_results.events():
        n = e.name()[3:] if e.name().startswith("mq.") else None
        if n in out and e.device_type() != DeviceType.CUDA:
            out[n].append(e.start_ns() * 1e-9)
    return {n: sorted(v) for n, v in out.items()}


def stage_table(recs: list, ops: list, prof, frame_ms: float, smi: str, label: str) -> None:
    """Print each recorded span's time, busy time and idle a frame (see the
    module's docstring, part 1)."""
    frames = sorted({r["frame"] for r in recs})
    n = len(frames)
    # the profiler's clock against the host's: the first span of each frame
    # opened it, and its host range starts with it
    first = {}
    for r in recs:
        if r["start_s"] is not None and (r["frame"] not in first
                                         or r["start_s"] < first[r["frame"]]["start_s"]):
            first[r["frame"]] = r
    names = {first[f]["name"] for f in frames if f in first}
    ranges = host_ranges(prof, names)
    seen = {nm: 0 for nm in names}
    offsets = []
    for f in frames:
        r = first.get(f)
        if r is None:
            continue
        i = seen[r["name"]]
        seen[r["name"]] += 1
        if i < len(ranges[r["name"]]):
            offsets.append(ranges[r["name"]][i] - r["start_s"])
    off = statistics.median(offsets) if offsets else None
    ops = sorted((a, b, nm) for nm, a, b in ops)
    rows: dict[str, list] = {}
    holes: dict[tuple, float] = {}  # (stage, op before, op after): idle ms
    for r in recs:
        row = rows.setdefault(r["name"], [r["parent"], 0.0, 0.0])
        row[1] += r["ms"]
        if off is None or r["start_s"] is None:
            continue
        s, e = r["start_s"] + off, r["end_s"] + off
        inside = [(max(a, s), min(b, e), nm) for a, b, nm in ops if b > s and a < e]
        row[2] += devtrace.union([(a, b) for a, b, _ in inside]) * 1e3
        # its idle stretches, by the operations around them
        t, before = s, "start"
        for a, b, nm in inside + [(e, e, "end")]:
            if a > t:
                key = (r["name"], before, nm)
                holes[key] = holes.get(key, 0.0) + (a - t) * 1e3
            if b >= t:
                t, before = b, nm
    # in the order the stages start in a frame
    start = {}
    for r in recs:
        if r["start_s"] is not None:
            start[r["name"]] = min(start.get(r["name"], r["start_s"]), r["start_s"])
    order = sorted(rows, key=lambda k: start.get(k, float("inf")))
    print(f"stages {label} [{smi}]: {n} frames, frame {frame_ms:.2f} ms (host clock); "
          "ms a frame: time (device where the span has events), busy, idle, share of the frame; "
          "under each, its longest idle stretches between two operations",
          flush=True)
    for name in order:
        parent, ms, busy = rows[name]
        ms, busy = ms / n, busy / n
        pad = "  " if parent else ""
        print(f"  {pad}{name:<26} {ms:9.3f} busy {busy:9.3f} "
              f"idle {ms - busy:9.3f} {ms / frame_ms:7.2%}", flush=True)
        mine = sorted(((v / n, a, b) for (st, a, b), v in holes.items() if st == name),
                      reverse=True)
        for v, a, b in mine[:3]:
            if v >= 0.05:
                print(f"  {pad}    idle {v:8.3f} between {a[:60]} and {b[:60]}", flush=True)
    s = profiler.summary()
    tops = [k for k, v in s["spans"].items()
            if v["parent"] is None and not k.startswith(("step.", "refresh."))]
    tiled = sum(s["spans"][k]["ms"] for k in tops) / n
    rep = s["replays"]
    if rep["frames"]:
        print(f"  replay call to graph end {rep['ms'] / rep['frames']:.3f} ms a frame; "
              f"lead + top-level stages ({', '.join(tops)}) {tiled:.3f}", flush=True)
    for k, v in sorted(s["counters"].items()):
        print(f"  counter {k:<28} {v / n:16.1f} a frame", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--integrator", choices=("pt", "restir", "mcpg"), default="pt")
    ap.add_argument("--frames", type=int, default=4, help="frames in the profile")
    ap.add_argument("--out", default=os.path.join(ROOT, "profiling"),
                    help="directory for profile_frame_<integrator>.txt")
    ap.add_argument("--n-buildings", type=int, default=None,
                    help="city's building count (default: its own; 28000 is the map scene)")
    ap.add_argument("--seed", type=int, default=None,
                    help="city's seed (default: its own); with --workload the run's seed")
    ap.add_argument("--scene", choices=("city", "court"), default="city")
    ap.add_argument("--fog", type=float, default=None,
                    help="the court's fog extinction; with mcpg, the volume pass runs")
    ap.add_argument("--production", action="store_true",
                    help="mcpg with production_config() (33.6M chain states, 2 volume spp)")
    ap.add_argument("--workload", default=None,
                    help="a cell of BENCHMARK.json (<config>.<mix>) instead of the scene options")
    ap.add_argument("--cost", type=int, default=0,
                    help="rounds of frames with the tracer recording and not, in turns")
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

    if args.workload:
        from quakebench import scenes, spec

        cell = spec.cell(spec.load_benchmark(), args.workload)
        seed = args.seed if args.seed is not None else 1
        pc = scenes.ProgramCell(spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                                seed, dev, scenes.Spans(False))
        label = tag = args.workload
        integ = pc.config.integrator
        frame = 1

        def captured():
            nonlocal frame
            pc.frame(frame)
            frame += 1

        warm = pc.mix["settle_frames"] + 8
    else:
        scene_kw = {k: v for k, v in (("n_buildings", args.n_buildings), ("seed", args.seed))
                    if v is not None}
        if args.scene == "court":
            bundle = outdoor_court(args.fog or 0.0, device=dev)
            scene_kw = {"fog_mu_t": args.fog or 0.0}
        else:
            bundle = city(**scene_kw, device=dev)
        accel = build_accel(bundle.scene, bundle.atlas)
        kernel = woop.woop_stream if woop.streamed(accel.woop_w) else woop.woop_nearest
        print(f"scene {args.scene}({scene_kw or 'defaults'}): {bundle.scene.num_tris} "
              f"triangles, traced by {kernel.__name__}", flush=True)
        tag = f"_{args.n_buildings}" if args.n_buildings is not None else ""
        tag += "_court" if args.scene == "court" else ""
        tag += "_fog" if args.fog else ""
        tag += "_production" if args.production else ""
        tag = args.integrator + tag
        label = integ = args.integrator
        feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
        config = RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL, features=feats,
                              integrator=args.integrator)
        mcfg = MCPGConfig(volume=VolumeConfig()) if args.fog else MCPGConfig()
        mcfg = production_config() if args.production else mcfg
        rcfg = {"restir": restir_pkg.ReSTIRConfig(), "mcpg": mcfg}.get(args.integrator)
        u = bundle.uniforms
        cf = compile_frame(accel, bundle.atlas, config, init_state(config, rcfg, device=dev),
                           rcfg)
        frame = 0

        def captured():
            nonlocal frame
            cf(u._replace(frame=frame))
            frame += 1

        # warm up: kernel build, allocator, first launches; the chains' learning
        warm = 12 if args.integrator == "mcpg" else 2

    step = lambda: (captured(), torch.cuda.synchronize())
    for _ in range(warm):
        step()

    # ---- 1 and 2: the stage table and the device time by op, one trace ----
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    recs = profiler.records()
    ops, _ = devtrace.read_profiler(prof)
    stage_table(recs, ops, prof, wall_ms / args.frames, smi, label)
    avgs = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    rows = sorted(avgs, key=dev_us, reverse=True)
    # device-side events (kernels, copies) carry the time once; the ops
    # that launched them repeat it as their self device time
    on_dev = [e for e in rows if e.device_type.name != "CPU"]
    ops_cpu = [e for e in rows if e.device_type.name == "CPU" and dev_us(e) > 0]
    total_ms = sum(dev_us(e) for e in on_dev) / 1e3
    print(f"profile {label} [{smi}]: {args.frames} frames, wall {wall_ms:.1f} ms, device "
          f"{total_ms:.1f} ms, busy {total_ms / wall_ms:.3f}, "
          f"{sum(e.count for e in on_dev)} device kernels/copies", flush=True)
    for kind, sel in (("op", ops_cpu[:12]), ("kernel", on_dev[:8])):
        for e in sel:
            print(f"  {kind:6s} {dev_us(e) / 1e3:9.2f} ms {dev_us(e) / 1e3 / total_ms:6.1%} "
                  f"x{e.count:<6d} {e.key[:90]}")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_frame_{tag}.txt"), "w") as f:
        f.write(f"{smi}\n")
        f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=80))

    # ---- 3: the tracer recording against not ----
    if args.cost:
        turns = {"off": [], "on": []}
        for _ in range(args.cost):
            for turn in ("off", "on", "on", "off"):
                prev = profiler.install(profiler.Profiler(enabled=turn == "on"))
                try:
                    step()
                    turns[turn].append(float(np.mean([host_ms(captured)[1] for _ in range(8)])))
                finally:
                    profiler.install(prev)
        print(f"cost {label} [{smi}]: " + "; ".join(
            f"recording {k} {'/'.join(f'{x:.2f}' for x in v)} ms/frame (mean {np.mean(v):.2f})"
            for k, v in turns.items()) + " (host clock, 8 frames a turn)", flush=True)

    if args.workload or integ == "restir":
        return 0

    # ---- 4: bounce sort vs none, on eager frames ----
    state = init_state(config, rcfg, device=dev)

    def eager():
        nonlocal state, frame
        state, _ = render_frame(accel, bundle.atlas, u._replace(frame=frame), config, state, rcfg)
        frame += 1

    for _ in range(2):
        eager()
    if args.integrator == "pt":
        sort_one_trace(bundle, accel, config, dev, kernel, smi)

    # the whole frame: the integrator's bounce traces sorted, and as they lie
    frames_ms = {}
    mod = pt_mod if args.integrator == "pt" else surface_mod
    plain_trace = mod.trace_ray
    try:
        for turn in ("sort", "none", "none", "sort"):
            if turn == "sort":
                mod.trace_ray = lambda *a, **k: plain_trace(*a, **{**k, "sort_rays": True})
            else:
                mod.trace_ray = plain_trace
            eager()
            ms = [host_ms(eager)[1] for _ in range(5)]
            frames_ms.setdefault(turn, []).append(float(np.mean(ms)))
    finally:
        mod.trace_ray = plain_trace
    print(f"sort frame {args.integrator} [{smi}]: " + "; ".join(
        f"{k} {'/'.join(f'{x:.2f}' for x in v)} ms/frame" for k, v in frames_ms.items())
        + " (host clock, mean of 5 steady frames per turn)", flush=True)
    return 0


def sort_one_trace(bundle, accel, config, dev, kernel, smi):
    """One 2,073,600-ray bounce population traced with the coherence sort
    and without: the same hits, the whole trace and its kernel timed."""
    bo, bd, bt = fixtures.bounce_rays(bundle, accel, config, dev)
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
        whole = common.cuda_time(lambda: trace(label == "sort"), 10)
        k1 = common.cuda_time(lambda: kernel(*k1_args[label]), 10)
        times.setdefault(label, []).append((whole, k1))
    print(f"sort bounce {W * H} rays [{smi}]: " + "; ".join(
        f"{k}: trace {'/'.join(f'{a:.3f}' for a, _ in v)} ms, "
        f"{kernel.__name__} {'/'.join(f'{b:.3f}' for _, b in v)} ms" for k, v in times.items()),
        flush=True)


if __name__ == "__main__":
    sys.exit(main())
