"""F7's replay scan (29), the live dungeon and arena captured against
eager (30-31), the live dungeon on the CPU against the card (32), the
orbit presets (33), the CLI (34) and SSMM on the live dungeon (41)."""
from __future__ import annotations

import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .common import (
    FOG_MU_T, H, MEAN_TOL, MPL, PIX_SHARE, PIX_TOL, PROFILE_MS, SPP, SUBSET, W, check_exact,
    check_k2, check_mcpg_finite, cuda_time, differing_leaves, launches, log, mcpg_scene_config,
    profiled, reset_launches, sync_sites,
)
from .fixtures import aimed_rays, bounce_rays, court, keep, primary_rays
from .presets import preset_pair


# frames of each F7 A/B run (the last 4 timed) and the turns of the A/B
F7_FRAMES, F7_TURNS = 6, ("parent", "change", "change", "parent")
# the live dungeon at full width (make_bigmap's defaults) and its frames,
# as bench.py's live_scale row: 7 settle frames (5-7 steady), 3 timed
# the live loop captured against eager (phases 30-31): moving frames,
# then (the dungeon) the stale-cache mutant's frames
LIVE_FRAMES, LIVE_MUTANT = 10, 4
# the incremental accel against a full build of the same frame:
# tests/test_live.py's tolerance on t (hits and misses equal)
LIVE_T_RTOL, LIVE_T_ATOL = 1e-5, 1e-3
# the CPU-vs-card live dungeon: grid 3, 4 monsters, dynamic capacity 512,
# 3 steps, 64x40
SMALL_DUNGEON, SMALL_W, SMALL_H = {"grid": 3, "monsters": 4, "dynamic_capacity": 512}, 64, 40


def f7_runs(accel, atlas, uniforms, config, mcfg, dev, frames=F7_FRAMES):
    """``frames`` frame_core frames from an empty state: (state, out, host
    ms of each frame, synced)."""
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    state = init_state(config, mcfg, device=dev)
    ms = []
    for i in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = render_frame(accel, atlas, uniforms._replace(frame=i), config, state, mcfg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, out, ms


def f7_tensors(state, out):
    return {"mc.f": state.mcpg.mc.f, "mc.i": state.mcpg.mc.i, "lc.irr": state.mcpg.lc.irr,
            "accum_irradiance": state.accum_irradiance, "ldr": out["ldr"]}


def phase29(dev, smi, city_scene):
    """F7: two frame_core runs from one state are bit-equal in the default
    mode (city MCPG); the parent's scan (``torch.cumsum``) against the
    repair (``segments.scan_rows``), frames in turns, on city MCPG and the
    fogged court with the volume pass."""
    from merian_quake_tpu_torch.ops import segments
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig

    bundle, accel, config = city_scene
    repaired = segments.scan_rows
    parent = lambda x: torch.cumsum(x, dim=1)  # what compact_sums ran before the repair
    cfg, mcfg = mcpg_scene_config(config)
    runs = {}
    for name, scan in (("change", repaired), ("parent", parent)):
        segments.scan_rows = scan
        try:
            a, b = (f7_tensors(*f7_runs(accel, bundle.atlas, bundle.uniforms, cfg, mcfg, dev)[:2])
                    for _ in range(2))
        finally:
            segments.scan_rows = repaired
        runs[name] = [k for k in a if not torch.equal(a[k], b[k])]
    log(f"phase 29 F7 city mcpg {W}x{H}, two runs of {F7_FRAMES} frames from one state [{smi}]: "
        f"tensors that differ, the repair {runs['change'] or 'none'}; the parent's cumsum "
        f"{runs['parent'] or 'none'}")
    if runs["change"]:
        raise AssertionError(f"frame_core does not repeat itself: {runs['change']} differ")
    c_bundle, c_accel, c_cfg = court(dev, FOG_MU_T)
    c_cfg, c_mcfg = c_cfg._replace(integrator="mcpg"), MCPGConfig(volume=VolumeConfig())
    ab = {}
    for scene, args in (("city", (accel, bundle.atlas, bundle.uniforms, cfg, mcfg)),
                        ("court_volume", (c_accel, c_bundle.atlas, c_bundle.uniforms, c_cfg,
                                          c_mcfg))):
        turns = []
        for turn in F7_TURNS:
            segments.scan_rows = parent if turn == "parent" else repaired
            try:
                turns.append(float(np.mean(f7_runs(*args, dev)[2][2:])))
            finally:
                segments.scan_rows = repaired
        p_ms = (turns[0] + turns[3]) / 2
        c_ms = (turns[1] + turns[2]) / 2
        ab[scene] = {"turns_ms": turns, "parent_ms": p_ms, "change_ms": c_ms,
                     "cost": c_ms / p_ms - 1.0}
        log(f"phase 29 F7 A/B {scene} mcpg {W}x{H} [{smi}]: frames 2-{F7_FRAMES - 1} in turns "
            f"{', '.join(f'{t} {x:.2f}' for t, x in zip(F7_TURNS, turns))} ms/frame; the repair "
            f"costs {100 * ab[scene]['cost']:+.2f}% of the frame")
    return {"repeats": not runs["change"], "parent_differs": runs["parent"], **ab}


class LiveRun:
    """The live dungeon (or arena) and its live accel on the card, with the
    frame config the slice renders it at."""

    def __init__(self, dev, live, la, config, mcfg):
        self.dev, self.live, self.la, self.config, self.mcfg = dev, live, la, config, mcfg
        self.state = None
        self.i = 0

    def step(self, render=True, sync=True):
        """One frame of the slice's path: (step s, refresh s, render s, out);
        with ``sync`` the frame ends in a synchronize."""
        from merian_quake_tpu_torch.accel.build import refresh_dynamic
        from merian_quake_tpu_torch.renderer import init_state, render_frame

        if self.state is None:
            self.state = init_state(self.config, self.mcfg, device=self.dev)
        t0 = time.perf_counter()
        self.dyn, self.uniforms = self.live.step_dynamic(dt=1.0 / 30.0, forward=120.0,
                                                         yaw=25.0 + 2.0 * self.i)
        t1 = time.perf_counter()
        self.la = refresh_dynamic(self.la, self.dyn)
        t2 = time.perf_counter()
        out = None
        if render:
            self.state, out = render_frame(self.la.accel, self.live.gs.static_bundle.atlas,
                                           self.uniforms, self.config, self.state, self.mcfg)
        if sync:
            torch.cuda.synchronize()
        self.i += 1
        return t1 - t0, t2 - t1, time.perf_counter() - t2, out


def live_config(live, integrator="mcpg", width=W, height=H, mpl=MPL, spp=SPP):
    from merian_quake_tpu_torch.cli import live_features
    from merian_quake_tpu_torch.models.types import RenderConfig

    return RenderConfig(width=width, height=height, spp=spp, max_path_length=mpl,
                        integrator=integrator, features=live_features(live.gs.static_bundle))


def derived_tensors(acc) -> dict:
    """Every tensor kept on the accel's tables (``woop._cached``: padded
    bounds, the walk boxes on them, K8's table), by where it is kept."""
    out = {}

    def walk(owner, where):
        for key, (_, value, _) in owner.__dict__.get("_mq_cache", {}).items():
            for j, t in enumerate(value if isinstance(value, tuple) else (value,)):
                out[f"{where}/{key}/{j}"] = t
                walk(t, f"{where}/{key}/{j}")

    for field in ("cluster_lo", "cluster_lo_alpha", "cluster_lo_proxy"):
        if getattr(acc, field) is not None:
            walk(getattr(acc, field), field)
    walk(acc.scene.v0, "scene.v0")
    return out


def live_pair(phase, path, dev, smi, live, config, mcfg, frames=LIVE_FRAMES, mutant=0, yaw0=25.0):
    """The live loop captured against eager. ``frames + mutant`` frames of
    ``live`` (``step_dynamic``: the player walks and turns, the entities
    move) are recorded once, then fed to two ``build_accel_live`` copies of
    its static map, in turns, each frame synced: one refreshed and rendered
    eagerly (``render_frame``), one refreshed and rendered through
    ``compile_frame`` (frame 0's call warms up, captures and replays; then a
    replay a frame). Every frame's state and outputs bit for bit; each
    refresh of the captured copy after the first reads no device value
    (``sync_sites``; the first's are logged) and keeps the storage of
    every table derived from the tables, each
    equal to a fresh computation (``table_invariants``). Then ``mutant``
    frames whose refresh of the captured copy leaves the derived tables as
    they were (``woop.rewrite_cached`` a no-op): the captured frames must
    differ from eager. Last, the device's busy share of each (profiler).
    Returns (a LiveRun on the eager copy, the graph's launches, stats)."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.accel.build import build_accel_live, refresh_dynamic
    from merian_quake_tpu_torch.capture import WARMUP_STEPS, tree_map
    from merian_quake_tpu_torch.renderer import compile_frame, init_state, render_frame

    bundle = live.gs.static_bundle
    t0 = time.perf_counter()
    rec = [live.step_dynamic(dt=1.0 / 30.0, forward=120.0, yaw=yaw0 + 2.0 * i)
           for i in range(frames + mutant)]
    step_ms = (time.perf_counter() - t0) / len(rec) * 1e3
    t0 = time.perf_counter()
    la_e = build_accel_live(bundle, dyn_cap=live.gs.dynamic_capacity, device=dev)
    torch.cuda.synchronize()
    accel_s = time.perf_counter() - t0
    la_c = build_accel_live(bundle, dyn_cap=live.gs.dynamic_capacity, device=dev)
    kernel = "woop_stream" if woop.streamed(la_c.accel.woop_w) else "woop_nearest"
    state_e, cf, held = init_state(config, mcfg, device=dev), None, None
    e_ms, c_ms, e_refresh, c_refresh, e_launch, differs = [], [], [], [], [], []
    plain_rewrite = woop.rewrite_cached
    for i, (dyn, u) in enumerate(rec):
        torch.cuda.synchronize()
        before = launches()
        t0 = time.perf_counter()
        la_e = refresh_dynamic(la_e, dyn)
        t1 = time.perf_counter()
        state_e, out_e = render_frame(la_e.accel, bundle.atlas, u, config, state_e, mcfg)
        torch.cuda.synchronize()
        e_refresh.append((t1 - t0) * 1e3)
        e_ms.append((time.perf_counter() - t1) * 1e3)
        e_launch.append({k: v - before[k] for k, v in launches().items() if v - before[k]})
        if i >= frames:  # the stale-cache mutant
            woop.rewrite_cached = lambda owner: None
        try:
            t0 = time.perf_counter()
            la_c, sites = sync_sites(lambda: refresh_dynamic(la_c, dyn))
            c_refresh.append((time.perf_counter() - t0) * 1e3)
        finally:
            woop.rewrite_cached = plain_rewrite
        if i == 0:
            # the process's first pinned copies in the "warn" mode may add a
            # synchronizing call of torch's own (torch/cuda/__init__.py):
            # logged, and every later refresh, the same code, is held
            first_sites = sites
        elif sites:
            raise AssertionError(f"phase {phase} {path} frame {i}: the refresh reads the device: "
                                 f"{sites}")
        if cf is None:
            before = launches()
            cf = compile_frame(la_c.accel, bundle.atlas, config, init_state(config, mcfg, device=dev),
                               mcfg)
            t0 = time.perf_counter()
            state_c, out_c = cf(u)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts = {k: v - before[k] for k, v in launches().items() if v - before[k]}
            if any(v % (WARMUP_STEPS + 1) for v in counts.values()):
                raise AssertionError(f"phase {phase} {path}: {counts} over the warm-up and the "
                                     f"capture are not {WARMUP_STEPS + 1} frames' launches")
            in_graph = {k: v // (WARMUP_STEPS + 1) for k, v in counts.items()}
        else:
            t0 = time.perf_counter()
            state_c, out_c = cf(u)
            torch.cuda.synchronize()
            c_ms.append((time.perf_counter() - t0) * 1e3)
        bad = differing_leaves(state_c, state_e) + differing_leaves(out_c, out_e)
        if i < frames:
            if bad:
                raise AssertionError(f"phase {phase} {path} frame {i}: the captured frame differs "
                                     f"from the eager one in leaves {bad}")
            stale = table_invariants(la_c.accel, woop.node_sizes(kernel))
            now = derived_tensors(la_c.accel)
            if held is None:
                held = now
            moved = sorted(k for k in set(held) | set(now)
                           if k not in held or k not in now or now[k].data_ptr() != held[k].data_ptr())
            if stale or moved:
                raise AssertionError(f"phase {phase} {path} frame {i}: refreshed tables {stale} "
                                     f"differ from fresh ones, {moved} moved")
        else:
            differs.append(bool(bad))
    if mutant and not any(differs):
        raise AssertionError(f"phase {phase} {path}: the stale-cache mutant's captured frames equal "
                             "the eager ones")
    fixed = tree_map(torch.clone, state_e)
    u = rec[-1][1]
    e_busy = profiled(lambda: render_frame(la_e.accel, bundle.atlas, u, config, fixed, mcfg),
                      max(1, math.ceil(PROFILE_MS / np.mean(e_ms[2:]))))
    c_busy = profiled(lambda: cf(u), max(1, math.ceil(PROFILE_MS / np.mean(c_ms[1:]))))
    cap = cf.captured
    stats = {"frames": frames, "step_ms": step_ms, "refresh_ms": float(np.mean(e_refresh[2:frames])),
             "captured_refresh_synced_ms": float(np.mean(c_refresh[2:frames])),
             "eager_ms": float(np.mean(e_ms[2:frames])), "captured_ms": float(np.mean(c_ms[1:frames - 1])),
             "eager_busy": e_busy[2], "captured_busy": c_busy[2], "eager_device_ms": e_busy[0],
             "captured_device_ms": c_busy[0], "first_call_s": first_s,
             "capture_s": cap.capture_seconds, "graph_pool_bytes": cap.pool_bytes,
             "launches_in_graph": in_graph, "eager_launches_per_frame": e_launch[:frames],
             "build_accel_live_s": accel_s, "h2d_bytes_per_frame": refresh_dynamic.h2d_bytes,
             "derived_tables_kept": len(held), "mutant_frames_differ": differs,
             "refresh_frame0_sync_sites": first_sites}
    stats["eager_live_ms"] = step_ms + stats["refresh_ms"] + stats["eager_ms"]
    stats["captured_live_ms"] = step_ms + stats["refresh_ms"] + stats["captured_ms"]
    log(f"phase {phase} {path} {config.integrator} {config.width}x{config.height} spp {config.spp} "
        f"mpl {config.max_path_length}, {frames} moving frames recorded once, two live accels "
        f"[{smi}]: step {step_ms:.2f} ms, refresh {stats['refresh_ms']:.2f} ms (the captured copy's, "
        f"synced and checked for host reads, {stats['captured_refresh_synced_ms']:.2f}); render "
        f"eager {stats['eager_ms']:.2f} ms (frames 2-{frames - 1}, busy {e_busy[2]:.3f}, device "
        f"{e_busy[0]:.2f}), captured {stats['captured_ms']:.2f} ms (busy {c_busy[2]:.3f}, device "
        f"{c_busy[0]:.2f}); live ms/frame {stats['eager_live_ms']:.2f} -> "
        f"{stats['captured_live_ms']:.2f}; capture {cap.capture_seconds:.3f} s (first call "
        f"{first_s:.2f} s), graph pool {cap.pool_bytes} bytes; launches in the graph {in_graph}, "
        f"eager a frame {e_launch[frames - 1]}; the refreshes' synchronizing calls: frame 0 "
        f"{first_sites or 'none'}, frames 1-{len(rec) - 1} none; {frames} frames bit-identical "
        f"to eager, "
        f"{len(held)} derived tables kept in place and equal to fresh ones each frame"
        + (f"; the stale-cache mutant's {mutant} frames differ from eager: {differs}" if mutant
           else ""))
    run = LiveRun(dev, live, la_e, config, mcfg)
    run.state, run.out, run.i = state_e, out_e, frames + mutant
    run.dyn, run.uniforms = rec[-1]
    return run, in_graph, stats


def refresh_split(la, dyn, reps=5) -> dict:
    """Where a refresh's time goes, on ``la`` (whose derived tables the
    frames made): host ms of ``dynamic_rows`` (numpy) and of the whole
    refresh ended by a synchronize, and the in-place rewrite of the derived
    tables alone (``build._rewrite_derived``: host ms, synced, and device
    ms by CUDA events), each a mean over ``reps`` calls."""
    from merian_quake_tpu_torch.accel import build

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    return {"dynamic_rows_ms": host_ms(lambda: build.dynamic_rows(la, dyn)),
            "refresh_synced_ms": host_ms(lambda: build.refresh_dynamic(la, dyn)),
            "rewrite_derived_ms": host_ms(lambda: build._rewrite_derived(la.accel)),
            "rewrite_derived_device_ms": cuda_time(lambda: build._rewrite_derived(la.accel), reps)}


def phase30(dev, smi):
    """The live dungeon at full width: the host library's build, the map,
    its live loop captured against eager over 10 moving frames (bench.py's
    live_scale frames) and the stale-cache mutant (``live_pair``), alpha
    walks a frame (K3's: one a trace, eager and in the graph), an eager
    frame with no host read, peak bytes."""
    from merian_quake_tpu_torch.game import host
    from merian_quake_tpu_torch.game.bigmap import make_bigmap
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig

    marks = [time.perf_counter()]
    lib = host.build_library()
    marks.append(time.perf_counter())
    live, _ = make_bigmap(device=dev)
    marks.append(time.perf_counter())
    host_s, map_s = np.diff(marks)
    log(f"phase 30 live dungeon: game host built with g++ in {host_s:.2f} s "
        f"({lib.rsplit('/', 1)[-1]}); make_bigmap() {map_s:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    run, in_graph, stats = live_pair(30, "live dungeon", dev, smi, live, live_config(live),
                                     MCPGConfig(), mutant=LIVE_MUTANT)
    path = launches()
    peak = torch.cuda.max_memory_allocated()
    # MCPG's 3 traces a frame, each one alpha walk on K3's walk
    per_frame = [e.get("woop_stream_alpha", 0) for e in stats["eager_launches_per_frame"]]
    others = {k: v for k, v in path.items() if v and k != "woop_stream_alpha"}
    if others or set(per_frame) != {3} or in_graph != {"woop_stream_alpha": 3}:
        raise AssertionError(f"the live dungeon launched {path} (alpha walks a frame {per_frame}, "
                             f"in the graph {in_graph})")
    check_mcpg_finite("live dungeon", run.state, run.out)
    valid = int(run.dyn["valid"].sum())
    if valid <= 0:
        raise AssertionError("the live dungeon draws no entity")
    # two more eager frames' host reads: the first frame read takes the
    # synchronizing call torch adds to a process's first call in the "warn"
    # mode (phase 27), the second is held: an eager live frame reads nothing
    # (the alpha loop, the only reader before the alpha walk, reads nothing)
    sync_sites(lambda: run.step(sync=False))
    _, sites = sync_sites(lambda: run.step(sync=False))
    if sites:
        raise AssertionError(f"an eager live frame synchronizes: {sites}")
    split = refresh_split(run.la, run.dyn)
    log(f"phase 30 live dungeon refresh [{smi}], {len(derived_tensors(run.la.accel))} derived "
        f"tables: dynamic_rows (numpy) {split['dynamic_rows_ms']:.2f} ms, the whole refresh synced "
        f"{split['refresh_synced_ms']:.2f} ms, of which the in-place rewrite of the derived tables "
        f"{split['rewrite_derived_ms']:.3f} ms (device {split['rewrite_derived_device_ms']:.3f} ms)")
    stats.update({"static_triangles": run.la.n_static, "dynamic_triangles": valid,
                  "host_build_s": float(host_s), "make_bigmap_s": float(map_s),
                  "alpha_walks_per_frame": per_frame, "host_reads_per_frame": len(sites),
                  "peak_device_bytes": peak, "refresh_split": split})
    log(f"phase 30 live dungeon [{smi}]: {run.la.n_static} static triangles, dynamic capacity "
        f"{run.la.dyn_cap}, {valid} dynamic triangles drawn; alpha walks (K3's) an eager frame "
        f"{per_frame}, in the captured frame's graph {in_graph['woop_stream_alpha']}; host reads "
        f"an eager frame {len(sites)}; refresh copies {stats['h2d_bytes_per_frame']} bytes to the card "
        f"a frame; peak {peak} bytes; ldr mean {float(run.out['ldr'].mean()):.4f}")
    keep(dungeon=run)
    return {"live_dungeon": path}, stats


def table_invariants(acc, node_sizes):
    """The refreshed tables against fresh computations: packed rows,
    padded bounds (as the traces cached them) and the walk's boxes."""
    from merian_quake_tpu_torch.accel import woop

    bad = []
    for w_name, lo_name, hi_name in (("woop_w", "cluster_lo", "cluster_hi"),
                                     ("woop_w_shadow", "cluster_lo", "cluster_hi"),
                                     ("woop_w_alpha", "cluster_lo_alpha", "cluster_hi_alpha")):
        w, lo, hi = getattr(acc, w_name), getattr(acc, lo_name), getattr(acc, hi_name)
        plo, phi = woop.padded_bounds(lo, hi)
        flo, fhi = (x.contiguous() for x in woop._pad_bounds(lo.clone(), hi.clone()))
        pairs = {"rows4": (woop.packed_rows(w), w[:, :4]), "padded_lo": (plo, flo),
                 "padded_hi": (phi, fhi),
                 "walk_boxes": (woop.walk_boxes(plo, phi, *node_sizes),
                                woop.walk_boxes(flo.clone(), fhi.clone(), *node_sizes))}
        bad += [f"{w_name}.{k}" for k, (a, b) in pairs.items() if not torch.equal(a, b)]
    return bad


def live_checks(phase, name, run, populations, kernel, smi):
    """A refreshed live accel on the card: ``kernel`` (K1 or K3) and, on
    the shadow table, its any-hit form, bit-equal to the plain versions on
    each population; the table invariants; the hits of a from-scratch
    build_accel of the same frame's full scene (hit/miss equal, t within
    tests/test_live.py's tolerance). Returns the largest |t difference|
    against the plain versions and the readings."""
    from merian_quake_tpu_torch.accel import build_accel, woop

    la, acc = run.la, run.la.accel
    any_kernel = woop.woop_stream if kernel is woop.woop_stream else woop.woop_any
    max_abs, readings = [], {}
    bad = table_invariants(acc, woop.node_sizes(kernel.__name__))
    if bad:
        raise AssertionError(f"{name}: refreshed tables differ from fresh ones: {bad}")
    scene, _ = run.live.gs.extract()
    # numpy, as the refresh builds the dynamic rows (the static rows are the
    # native builder's; phase 35 holds the two builders' tables)
    full = build_accel(scene, run.live.gs.static_bundle.atlas, native=False)
    for pop, (o, d, t_max) in populations.items():
        n = o.shape[0]
        t_min = torch.zeros(n, device=o.device)
        args = woop.k1_inputs(acc, o, d, t_min, t_max)
        ref = woop.intersect_woop_reference(args[0], args[1])
        max_abs.append(check_exact(phase, f"{name} {pop} {n} {kernel.__name__}", kernel(*args), ref))
        rays, _, shadow = woop.k2_inputs(acc, o, d, t_min, t_max)
        occ = (any_kernel(rays, *shadow, anyhit=True) if any_kernel is woop.woop_stream
               else any_kernel(rays, *shadow))
        max_abs.append(check_k2(f"{name} {pop} {n} {any_kernel.__name__} shadow", occ,
                                woop.intersect_woop_any_reference(rays, shadow[0]), phase))
        a = woop.intersect_woop(acc, o, d, 0.0, t_max)
        b = woop.intersect_woop(full, o, d, 0.0, t_max)
        hit_differ = int((a.hit != b.hit).sum())
        t_ok = torch.isclose(a.t[b.hit], b.t[b.hit], rtol=LIVE_T_RTOL, atol=LIVE_T_ATOL)
        on_dyn = int((a.tri >= la.n_static).sum())
        readings[pop] = {"rays": n, "hits": int(b.hit.sum()), "dynamic_hits": on_dyn,
                         "hit_differ": hit_differ, "t_differ": int((~t_ok).sum())}
        log(f"phase {phase} {name} {pop}: against a full build_accel of the frame's scene: hits "
            f"{int(b.hit.sum())} of {n}, on the dynamic suffix {on_dyn}, hit/miss differ "
            f"{hit_differ}, t outside rtol {LIVE_T_RTOL} / atol {LIVE_T_ATOL}: "
            f"{int((~t_ok).sum())}")
        if hit_differ or not bool(t_ok.all()):
            raise AssertionError(f"{name} {pop}: the live accel does not hit as a full build does")
    return max(max_abs), readings


def dungeon_populations(run, dev):
    """65,536-ray subsets of the frame's primary and bounce rays, and rays
    aimed at the monsters."""
    import types

    from merian_quake_tpu_torch.accel import woop

    bundle = types.SimpleNamespace(uniforms=run.uniforms, atlas=run.live.gs.static_bundle.atlas)
    po, pd = primary_rays(bundle, run.la.accel, dev)
    bo, bd, bt = bounce_rays(bundle, run.la.accel, run.config._replace(integrator="pt"), dev)
    mid = slice(W * H // 2, W * H // 2 + SUBSET)
    ao, ad = aimed_rays(run.la.accel, run.la.n_static, SUBSET, 13)
    full = lambda v: torch.full((SUBSET,), v, device=dev)
    return {"primary": (po[mid].contiguous(), pd[mid].contiguous(), full(1e4)),
            "bounce": (bo[mid].contiguous(), bd[mid].contiguous(), bt[mid].contiguous()),
            "aimed at the monsters": (ao, ad, full(1e4))}


def phase31(dev, smi, dungeon):
    """The refresh against fresh tables on the card, after the moving
    steps of phase 30 (the dungeon, K3) and of the live arena (K1, K2);
    the arena's live frames (MCPG: K1; ReSTIR: K1 + K2) at 1080p captured
    against eager over 10 moving frames (``live_pair``); the rows4 mutant
    must fail the dungeon's check."""
    from merian_quake_tpu_torch.accel import build, woop
    from merian_quake_tpu_torch.game.mod import make_arena
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig

    if not woop.streamed(dungeon.la.accel.woop_w):
        raise AssertionError("the live dungeon's table is not streamed (K3)")
    k3_err, k3_read = live_checks(31, "live dungeon", dungeon, dungeon_populations(dungeon, dev),
                                  woop.woop_stream, smi)

    paths, arena_stats = {}, {}
    # live_features forces the alpha loop on: every nearest-hit trace is an
    # alpha walk (K1's), ReSTIR's visibility K2 and an alpha walk
    for integ, icfg, expect in (("mcpg", MCPGConfig(), ("woop_nearest_alpha",)),
                                ("restir", ReSTIRConfig(), ("woop_nearest_alpha", "woop_any"))):
        live = make_arena(dynamic_capacity=1024, device=dev)
        reset_launches()
        run, in_graph, st = live_pair(31, f"live arena {integ}", dev, smi, live,
                                      live_config(live, integ), icfg)
        got = launches()
        if (any(got[k] == 0 for k in expect) or any(v for k, v in got.items() if k not in expect)
                or set(in_graph) != set(expect)):
            raise AssertionError(f"the live arena ({integ}) launched {got}, in the graph {in_graph}")
        paths[f"live_arena_{integ}"] = got
        arena_stats[integ] = st
    if woop.streamed(run.la.accel.woop_w):
        raise AssertionError("the live arena's table is streamed: K1/K2 expected")
    o, d = aimed_rays(run.la.accel, run.la.n_static, SUBSET, 17)
    pops = {"aimed at the entities": (o, d, torch.full((SUBSET,), 1e4, device=dev))}
    k12_err, k12_read = live_checks(31, "live arena", run, pops, woop.woop_nearest, smi)

    # the mutant: the refresh leaves the packed rows as they were
    write_table = build._write_table
    build._write_table = build._write
    try:
        dungeon.step(render=False)
        o, d, t_max = dungeon_populations(dungeon, dev)["aimed at the monsters"]
        args = woop.k1_inputs(dungeon.la.accel, o, d, torch.zeros_like(t_max), t_max)
        try:
            check_exact(31, "live dungeon rows4 mutant (must differ)", woop.woop_stream(*args),
                        woop.intersect_woop_reference(args[0], args[1]))
        except AssertionError:
            caught = True
        else:
            caught = False
    finally:
        build._write_table = write_table
    dungeon.step(render=False)  # the tables whole again
    log(f"phase 31 the rows4 mutant (a refresh that does not rewrite the packed rows) fails the "
        f"K3 check: {caught}")
    if not caught:
        raise AssertionError("the rows4 mutant passed the refreshed-table check")
    return paths, {"k3": k3_read, "k1_k2_arena": k12_read, **arena_stats,
                   "max_abs_err": max(k3_err, k12_err)}


def phase32(dev, smi):
    """CPU against card: the live dungeon (grid 3, 4 monsters) after 3
    steps, a PT (mpl 2) and an MCPG frame at 64x40."""
    from merian_quake_tpu_torch.accel.build import build_accel_live, refresh_dynamic
    from merian_quake_tpu_torch.game.bigmap import make_bigmap
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    outs = {}
    for device in ("cpu", dev):
        live, _ = make_bigmap(**SMALL_DUNGEON, device=device)
        la = build_accel_live(live.gs.static_bundle, dyn_cap=live.gs.dynamic_capacity,
                              device=device)
        for i in range(3):
            dyn, u = live.step_dynamic(dt=1 / 30, forward=100.0, yaw=15.0 + i)
            la = refresh_dynamic(la, dyn)
        for integ, mpl, mcfg in (("pt", 2, None), ("mcpg", 3, MCPGConfig())):
            cfg = live_config(live, integ, SMALL_W, SMALL_H, mpl, 1)
            _, out = render_frame(la.accel, live.gs.static_bundle.atlas, u, cfg,
                                  init_state(cfg, mcfg, device=device), mcfg)
            outs[(str(device), integ)] = out["ldr"].cpu()
    stats = {}
    for integ in ("pt", "mcpg"):
        diff = (outs[("cpu", integ)] - outs[(str(dev), integ)]).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        mean = float(diff.mean())
        stats[integ] = {"share": share, "mean": mean}
        log(f"phase 32 live dungeon grid 3 cpu vs cuda {SMALL_W}x{SMALL_H} {integ} after 3 steps: "
            f"pixels within {PIX_TOL} {share:.5f}, mean |d| {mean:.3e}")
        if share < PIX_SHARE or mean >= MEAN_TOL:
            raise AssertionError(f"the live dungeon's {integ} frame: CPU and card disagree")
    return stats


# the orbit presets' frames through run_preset: only K1 (small scenes); on
# the court (config4's SSMM, 1 spp: 2 traces a frame; config5's fogged MCPG
# + volume: 4) each trace is one alpha walk, K1's
ORBIT_PRESETS = ("config2", "config4", "config5")
ORBIT_LAUNCHES = {"config4": {"woop_nearest_alpha": 2}, "config5": {"woop_nearest_alpha": 4}}


def phase33(dev, smi):
    """run_preset for the orbit presets at their named sizes and frames,
    captured against eager (``preset_pair``; the eager frames render the
    accel built for each frame, the captured ones the tables it is written
    into), every frame bit for bit."""
    paths, stats = {}, {}
    for name in ORBIT_PRESETS:
        paths[f"preset_{name}"], stats[name] = preset_pair(33, name, dev, smi,
                                                           ORBIT_LAUNCHES.get(name))
    return paths, stats


def phase34(dev, smi):
    """``python -m merian_quake_tpu_torch.cli play --map bigmap`` at 1080p
    MCPG, 3 frames, in a subprocess on the card: it writes its PNG."""
    import os
    import tempfile

    from merian_quake_tpu_torch.utils.image import load_png

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "play.png")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "merian_quake_tpu_torch.cli", "--device", str(dev), "play",
             "--map", "bigmap", "--frames", "3", "--size", f"{W}x{H}", "--spp", str(SPP),
             "--integrator", "mcpg", "--out", png],
            cwd=root, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cli play failed ({proc.returncode}): {proc.stderr[-3000:]}")
        img = load_png(png)
    if img.shape != (H, W, 3) or img.std() <= 0:
        raise AssertionError(f"cli play wrote an image of shape {img.shape}, std {img.std()}")
    lines = [x for x in proc.stdout.splitlines() if x.startswith(("played", "wrote"))]
    log(f"phase 34 cli play --map bigmap --frames 3 {W}x{H} mcpg in a subprocess [{smi}]: "
        f"{secs:.1f} s; {' | '.join(lines)}")
    return {"seconds": secs}


def phase41(dev, smi):
    """SSMM on the live dungeon at 1080p with config4's settings (1 spp,
    ``SSMMConfig()``, the denoise chain): its live loop captured against
    eager over 10 moving frames (``live_pair``), one K3 alpha walk for the
    gbuffer and one for SSMM's bounce a frame; then the port's tracer on
    the captured frame: two compiled runs from one state over the same
    recorded frames, frames 2-4 of the second recorded, equal bit for bit
    to the first; the replay's lead and top-level stages tile the replay,
    ``ssmm``'s five stage spans tile ``ssmm``; the last frame's counters
    equal to an eager ``render_ssmm``'s on the same state, gbuffer and
    uniforms (whose image and state equal the captured frame's), and its
    live pixels to its gbuffer's."""
    from merian_quake_tpu_torch.accel.build import build_accel_live, refresh_dynamic
    from merian_quake_tpu_torch.capture import tree_map
    from merian_quake_tpu_torch.game import host
    from merian_quake_tpu_torch.game.bigmap import make_bigmap
    from merian_quake_tpu_torch.models.types import device_scalars
    from merian_quake_tpu_torch.render.hit import decompress_hit
    from merian_quake_tpu_torch.render.ssmm import SSMMConfig, render_ssmm
    from merian_quake_tpu_torch.renderer import compile_frame, init_state
    from merian_quake_tpu_torch.utils import profiler

    host.build_library()
    live, _ = make_bigmap(device=dev)
    config = live_config(live, "ssmm", spp=1)._replace(denoise=True)
    scfg = SSMMConfig()
    reset_launches()
    _, in_graph, stats = live_pair(41, "live dungeon SSMM", dev, smi, live, config, scfg)
    if in_graph.get("woop_stream_alpha") != 2:
        raise AssertionError(f"phase 41: the captured SSMM frame launched {in_graph}")

    bundle = live.gs.static_bundle
    rec = [live.step_dynamic(dt=1.0 / 30.0, forward=180.0, yaw=40.0 + 1.2 * i) for i in range(6)]
    la = build_accel_live(bundle, dyn_cap=live.gs.dynamic_capacity, device=dev)
    state0 = init_state(config, scfg, device=dev)
    clone = lambda x: tree_map(torch.clone, x)
    runs = {}
    for recording in (False, True):
        cf = compile_frame(la.accel, bundle.atlas, config, clone(state0), scfg)
        frames24, last = profiler.Profiler(enabled=recording), profiler.Profiler(enabled=recording)
        for i, (dyn, u) in enumerate(rec):
            if i == 2:
                prev = profiler.install(frames24)
            if i == len(rec) - 1:
                profiler.install(last)
                before = clone(cf.state)
            refresh_dynamic(la, dyn)
            # synced, as the benchmark's live frames are: the lead is the replay's own
            torch.cuda.synchronize()
            st, out = cf(u)
            torch.cuda.synchronize()
        profiler.install(prev)
        runs[recording] = (clone(st), {k: v for k, v in out.items() if k != "gbuffer"},
                           frames24.summary(), last.summary(), before, clone(out["gbuffer"]))
        del cf
    same = not (differing_leaves(runs[False][0], runs[True][0])
                or differing_leaves(runs[False][1], runs[True][1]))
    st, out, summary, last, before, gbuf = runs[True]
    spans, n = summary["spans"], max(summary["frames"], 1)
    tops = ("replay.lead", "gbuffer", "ssmm", "post", "carry")
    tiled = sum(spans[k]["ms"] for k in tops if k in spans) / n
    replay = summary["replays"]["ms"] / max(summary["replays"]["frames"], 1)
    stages = ("ssmm.inputs", "ssmm.exchange", "ssmm.sample", "ssmm.trace", "ssmm.chain",
              "ssmm.smis")
    kids = sum(spans[k]["ms"] for k in stages if k in spans) / n
    ssmm_ms = spans["ssmm"]["ms"] / n if "ssmm" in spans else 0.0

    # the last frame's counters against an eager pass on the same inputs
    eager = profiler.Profiler(enabled=True)
    prev = profiler.install(eager)
    try:
        irr, new_ssmm = render_ssmm(la.accel, bundle.atlas, device_scalars(rec[-1][1]), config,
                                    scfg, before.ssmm, gbuf)
        torch.cuda.synchronize()
        want = eager.summary()["counters"]
    finally:
        profiler.install(prev)
    got = {k: v for k, v in last["counters"].items() if k.startswith("ssmm.")}
    live_px = int((decompress_hit(gbuf.hits).albedo >= 1e-7).any(-1).sum())
    pass_same = torch.equal(irr, out["irradiance"]) and not differing_leaves(new_ssmm, st.ssmm)
    log(f"phase 41 tracer on the captured 1080p live dungeon SSMM frame [{smi}]: recorded and not "
        f"bit-equal {same}; ms a frame " + ", ".join(f"{k} {v['ms'] / n:.3f}"
                                                      for k, v in spans.items())
        + f"; replay call to graph end {replay:.3f} ms, lead + top-level {tiled:.3f} ms; ssmm "
        f"{ssmm_ms:.3f} ms, its stages {kids:.3f} ms; last frame's counters {got}, eager pass "
        f"{want}, live pixels of its gbuffer {live_px}; eager pass equal to the captured frame "
        f"{pass_same}")
    if not (same and summary["frames"] == 3 and set(tops) <= set(spans)
            and set(stages) <= set(spans) and abs(tiled - replay) <= 0.01 * replay
            and abs(kids - ssmm_ms) <= 0.01 * ssmm_ms and got == want
            and got.get("ssmm.pixels_live") == live_px and pass_same
            and runs[False][2]["frames"] == 0):
        raise AssertionError("phase 41: the tracer changed the captured SSMM frame, missed a "
                             "stage, does not tile the replay or ssmm, or miscounts")
    return {**stats, "tracer_ms": {k: v["ms"] / n for k, v in spans.items()},
            "tracer_replay_ms": replay, "counters": got}
