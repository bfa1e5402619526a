"""Presets and their certification (26), the frame graph (27) and the
debug views with the tracer on a captured frame (28)."""
from __future__ import annotations

import contextlib
import math
import os
import time

import numpy as np
import torch

from .common import (
    FOG_MU_T, H, MPL, PIX_TOL, PROFILE_MS, SPP, W, launches, log, profiled, reset_launches,
    sync_sites,
)
from .fixtures import court


# certify_presets on the card at the presets' named 640x360 with certify's
# default budgets (64 frames, 4 truth runs of 256): tests/test_certify.py's
# criteria, config1's PT against itself (ratio 1 exactly) and the
# guiding-bound config6 below 1
CERTIFY = ("config1", "config6")
# each preset frame's launches (cornell_box and the alcove have no
# alpha-tested triangles): PT and MCPG 1 primary + 2 bounce traces at 1
# spp, config3's ReSTIR 2 traces + 1 visibility sweep
PRESET_FRAME = {"config1": {"woop_nearest": 3}, "config6": {"woop_nearest": 3},
                "config3": {"woop_nearest": 2, "woop_any": 1}}
# tests/test_graph.py's tolerance for the PT graph (its accumulators
# reproject with zero motion, frame_core's average plainly)
GRAPH_PT_ATOL = 1e-5
# the debug views, CPU against card on the same state: view 3's colour is
# rounded once from f64 (render/mcpg/debug.py), the others are f32 chains
VIEW_TOL = dict(rtol=1e-5, atol=1e-6)


@contextlib.contextmanager
def frames_seen(eager=False):
    """While open, every ``renderer.CompiledFrame`` is watched: each one made
    gets an entry in ``captures``, which its first call on the card fills
    with its capture's (seconds, pool bytes) (None: never captured); each
    call's ``ldr`` and ``hdr`` are cloned on the device into ``images``
    while ``keep`` is set; ``last`` and ``uniforms`` are the last frame
    made and the last uniforms given (for a profile); ``core_calls``
    counts ``frame_core``'s calls through the compiled step (its warm-up
    and capture frames: a replay calls nothing). ``eager``: each call
    renders eager ``frame_core`` (the alpha loop reading the host) on the
    frame's state instead, the reference, on the accel built for the frame
    where an orbit preset writes one in (``accel.build.write_accel``
    records it, writing nothing)."""
    import types

    from merian_quake_tpu_torch import renderer
    from merian_quake_tpu_torch.accel import build

    seen = types.SimpleNamespace(captures=[], images=[], keep=True, core_calls=0, last=None,
                                 uniforms=None, accel=None)
    cls = renderer.CompiledFrame
    plain_init, plain_call, plain_core, plain_write = (cls.__init__, cls.__call__,
                                                       renderer.frame_core, build.write_accel)

    def init(self, *a, **k):
        plain_init(self, *a, **k)
        self.seen_index = len(seen.captures)
        seen.captures.append(None)
        seen.last = self

    def call(self, uniforms):
        if eager:
            accel, atlas, config, mcfg, schedule = self._step.args
            accel = accel if seen.accel is None else seen.accel
            self.state, out = plain_core(accel, atlas, uniforms, config, self.state,
                                         mcpg_config=mcfg, schedule=schedule)
        else:
            _, out = plain_call(self, uniforms)
            seen.captures[self.seen_index] = (self.captured.capture_seconds,
                                              self.captured.pool_bytes)
        if seen.keep:
            seen.images.append((out["ldr"].clone(), out["hdr"].clone()))
        seen.uniforms = uniforms
        return self.state, out

    def core(*a, **k):
        seen.core_calls += 1
        return plain_core(*a, **k)

    def record(dst, src):
        seen.accel = src
        return dst

    cls.__init__, cls.__call__, renderer.frame_core = init, call, core
    if eager:
        build.write_accel = record
    try:
        yield seen
    finally:
        cls.__init__, cls.__call__, renderer.frame_core = plain_init, plain_call, plain_core
        build.write_accel = plain_write


def check_captured(phase, what, seen):
    """Every compiled frame of a captured run captured on its first call, and
    frame_core ran only in the warm-ups and the captures (no eager frame
    among the timed ones). Returns (capture seconds, pool bytes) summed."""
    from merian_quake_tpu_torch.capture import WARMUP_STEPS

    if not seen.captures or any(c is None for c in seen.captures):
        raise AssertionError(f"phase {phase} {what}: a compiled frame did not capture: "
                             f"{seen.captures}")
    if seen.core_calls != (WARMUP_STEPS + 1) * len(seen.captures):
        raise AssertionError(f"phase {phase} {what}: frame_core ran {seen.core_calls} times for "
                             f"{len(seen.captures)} captures: an eager frame among the replays")
    return sum(c[0] for c in seen.captures), sum(c[1] for c in seen.captures)


def preset_pair(phase, name, dev, smi, per_frame=None):
    """``run_preset(name)`` captured, then eager (``frames_seen``): every
    frame's ldr and hdr bit for bit; the captured run's launches are its
    graph's (WARMUP_STEPS + 1 frames': ``per_frame`` each where given, K1
    and K2 only otherwise), the eager run's ``per_frame`` a frame; ms/frame
    (run_preset's, frames 1 on) and the device's busy share (torch.profiler,
    at least PROFILE_MS of further calls) of each. Returns (the captured
    run's launches, stats)."""
    from merian_quake_tpu_torch.capture import WARMUP_STEPS
    from merian_quake_tpu_torch.presets import PRESETS, run_preset

    p = PRESETS[name]
    runs = {}
    for mode in ("captured", "eager"):
        reset_launches()
        with frames_seen(eager=mode == "eager") as seen:
            _, out, spf = run_preset(name, device=dev)
            got = launches()
            for key in ("ldr", "hdr"):
                if not bool(torch.isfinite(out[key]).all()):
                    raise AssertionError(f"run_preset({name!r}) {mode}: {key} is not finite")
            if tuple(out["ldr"].shape) != (p.config.height, p.config.width, 3):
                raise AssertionError(f"run_preset({name!r}) ldr has the shape "
                                     f"{tuple(out['ldr'].shape)}")
            seen.keep = False
            cf, u = seen.last, seen.uniforms
            busy = profiled(lambda: cf(u), max(1, math.ceil(PROFILE_MS / (spf * 1e3))))
            del cf
            seen.last = None
        runs[mode] = (seen, got, spf, busy)
    (c_seen, c_got, c_spf, c_busy), (e_seen, e_got, e_spf, e_busy) = runs["captured"], runs["eager"]
    cap_s, pool = check_captured(phase, f"run_preset({name!r})", c_seen)
    in_graph = {k: v // (WARMUP_STEPS + 1) for k, v in c_got.items() if v}
    if per_frame is not None:
        want_c = {**{k: 0 for k in c_got}, **{k: v * (WARMUP_STEPS + 1) for k, v in per_frame.items()}}
        want_e = {**{k: 0 for k in e_got}, **{k: v * p.frames for k, v in per_frame.items()}}
        if c_got != want_c or e_got != want_e:
            raise AssertionError(f"run_preset({name!r}) launched {c_got} captured, {e_got} eager; "
                                 f"expected {want_c}, {want_e}")
    elif (any(v % (WARMUP_STEPS + 1) for v in c_got.values())
          or not (c_got["woop_nearest"] or c_got["woop_nearest_alpha"])
          or any(v for k, v in {**c_got, **e_got}.items()
                 if k not in ("woop_nearest", "woop_any", "woop_nearest_alpha"))):
        raise AssertionError(f"run_preset({name!r}) launched {c_got} captured, {e_got} eager")
    if len(c_seen.images) != p.frames or len(e_seen.images) != p.frames:
        raise AssertionError(f"run_preset({name!r}): {len(c_seen.images)} captured and "
                             f"{len(e_seen.images)} eager frames, not {p.frames}")
    bad = [i for i, (a, b) in enumerate(zip(c_seen.images, e_seen.images))
           if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))]
    if bad:
        raise AssertionError(f"run_preset({name!r}): captured frames {bad} differ from eager")
    stats = {"eager_ms": e_spf * 1e3, "captured_ms": c_spf * 1e3, "eager_busy": e_busy[2],
             "captured_busy": c_busy[2], "eager_device_ms": e_busy[0],
             "captured_device_ms": c_busy[0], "capture_s": cap_s, "graph_pool_bytes": pool,
             "launches_in_graph": in_graph, "eager_launches": {k: v for k, v in e_got.items() if v},
             "frames": p.frames}
    log(f"phase {phase} run_preset {name} {p.config.width}x{p.config.height} "
        f"{p.config.integrator} denoise={p.config.denoise} x{p.frames} frames [{smi}]: eager "
        f"{stats['eager_ms']:.2f} ms/frame (busy {e_busy[2]:.3f}, device {e_busy[0]:.2f} ms), "
        f"captured "
        f"{stats['captured_ms']:.2f} ms/frame (busy {c_busy[2]:.3f}, device {c_busy[0]:.2f} ms); "
        f"capture {cap_s:.3f} s, graph pool {pool} bytes; launches in the graph {in_graph} (eager "
        f"run {stats['eager_launches']}); all {p.frames} frames' ldr and hdr bit-identical to "
        f"eager; ldr mean {float(out['ldr'].mean()):.4f}")
    return c_got, stats


# certification captured against eager, each relMSE equal to the bit, at
# budgets a tenth of the default (the static presets at their named sizes;
# config3's steady skip, at a quarter of 1080p, restarts the accumulators
# of the graph's static state in place)
CERTIFY_PAIR = {"config1": dict(scale=1.0, frames=16, ref_frames=32, ref_runs=2),
                "config6": dict(scale=1.0, frames=16, ref_frames=32, ref_runs=2),
                "config3": dict(scale=0.25, frames=16, ref_frames=16, ref_runs=1, steady_skip=8)}
CERTIFY_KEYS = ("relmse", "relmse_pt_equal_budget", "relmse_trimmed", "relmse_trimmed_pt",
                "ratio_vs_pt")


def phase26(dev, smi):
    """Presets and certification, each frame captured in a CUDA graph:
    ``run_preset`` for config1 and config6 (640x360) and config3 (1080p)
    against eager, every frame bit for bit; ``certify_presets`` of config1
    and config6 at their named 640x360 with certify's default budgets and
    the equal-time columns, then config1, config6 and config3 (its steady
    skip) at small budgets captured against eager, each relMSE equal to
    the bit (the orbit presets: phase 33)."""
    import csv
    import tempfile

    from merian_quake_tpu_torch.capture import WARMUP_STEPS
    from merian_quake_tpu_torch.utils.certify import certify_presets

    paths, stats = {}, {"presets": {}, "certify": {}, "certify_pair": {}}
    for name, per_frame in PRESET_FRAME.items():
        paths[f"preset_{name}"], stats["presets"][name] = preset_pair(26, name, dev, smi, per_frame)

    with tempfile.TemporaryDirectory() as tmp:
        for name in CERTIFY:
            reset_launches()
            t0 = time.perf_counter()
            with frames_seen() as seen:
                seen.keep = False
                r = certify_presets([name], scale=1.0, convergence_dir=tmp, device=dev,
                                    equal_time=True)[name]
                seen.last = None
            secs = time.perf_counter() - t0
            got = launches()
            cap_s, pool = check_captured(26, f"certify {name}", seen)
            runs = len(seen.captures)
            want_runs = r["ref_runs"] + (1 if r["integrator"] == "pt" else 3)
            want = {**{k: 0 for k in got}, "woop_nearest": 3 * (WARMUP_STEPS + 1) * runs}
            if got != want or runs != want_runs:
                raise AssertionError(f"certify {name} launched {got} in {runs} compiled runs, "
                                     f"expected {want} in {want_runs}")
            with open(r["convergence_csv"]) as f:
                series = [(int(row["frames"]), float(row["relmse"]), float(row["relmse_trimmed"]))
                          for row in csv.DictReader(f)]
            values = [r[k] for k in ("relmse", "relmse_pt_equal_budget", "relmse_trimmed",
                                     "relmse_trimmed_pt")] + [x for s in series for x in s[1:]]
            frames = r["ref_frames"] * r["ref_runs"] + r["frames"] * (1 if r["integrator"] == "pt" else 2)
            log(f"phase 26 certify {name} {r['resolution']} {r['integrator']} frames {r['frames']}, "
                f"truth {r['ref_runs']} x {r['ref_frames']}, captured [{smi}]: relmse "
                f"{r['relmse']!r}, equal-budget reference {r['relmse_pt_equal_budget']!r}, "
                f"ratio_vs_pt {r['ratio_vs_pt']!r}, trimmed ratio {r['ratio_trimmed_vs_pt']!r}; "
                f"{r['ms_per_frame']:.3f} ms/frame, the truth's {r['ref_ms_per_frame']:.3f}; at "
                f"equal time the reference {r['pt_equal_time_frames']} frames, ratio "
                f"{r['ratio_vs_pt_equal_time']!r}; convergence (frames, relmse, trimmed) {series}; "
                f"{frames}+ frames in {runs} compiled runs (capture {cap_s:.2f} s, pools {pool} "
                f"bytes) in {secs:.1f} s; launches in the graphs { {k: v for k, v in got.items() if v} }")
            if not all(np.isfinite(v) for v in values):
                raise AssertionError(f"certify {name}: a relMSE is not finite")
            if series[0][0] != 1 or series[-1][0] != 64 or not series[-1][1] < series[0][1]:
                raise AssertionError(f"certify {name}: the convergence series does not fall: {series}")
            if name == "config1" and r["ratio_vs_pt"] != 1.0:
                raise AssertionError(f"certify config1: PT against itself gave {r['ratio_vs_pt']}")
            if name == "config6" and not r["ratio_vs_pt"] < 1.0:
                raise AssertionError(f"certify config6: guiding does not beat PT: {r['ratio_vs_pt']}")
            paths[f"certify_{name}"] = got
            stats["certify"][name] = {**{k: r[k] for k in (
                "resolution", "relmse", "relmse_pt_equal_budget", "ratio_vs_pt",
                "ratio_trimmed_vs_pt", "ms_per_frame", "ref_ms_per_frame",
                "ratio_vs_pt_equal_time")}, "convergence": series, "seconds": secs,
                "capture_s": cap_s, "graph_pool_bytes": pool}

    for name, kw in CERTIFY_PAIR.items():
        rows = {}
        for mode in ("captured", "eager"):
            with frames_seen(eager=mode == "eager") as seen:
                seen.keep = False
                rows[mode] = certify_presets([name], device=dev, equal_time=True, **kw)[name]
                # the last run's frame: the reference's (PT; for config1 the
                # truth's and the candidate's too)
                cf, u = seen.last, seen.uniforms
                busy = profiled(lambda: cf(u), max(1, math.ceil(
                    PROFILE_MS / rows[mode]["ref_ms_per_frame"])))
                del cf
                seen.last = None
            if mode == "captured":
                check_captured(26, f"certify {name} (pair)", seen)
            rows[mode]["busy"] = busy[2]
        c, e = rows["captured"], rows["eager"]
        differ = [k for k in CERTIFY_KEYS if c[k] != e[k]]
        stats["certify_pair"][name] = {
            "resolution": c["resolution"], **{k: c[k] for k in CERTIFY_KEYS},
            **{f"{m}_{k}": rows[m][k] for m in rows for k in ("ms_per_frame", "ref_ms_per_frame",
                                                               "busy")}}
        log(f"phase 26 certify {name} {c['resolution']} {c['integrator']} {kw} captured against "
            f"eager [{smi}]: relMSEs {[c[k] for k in CERTIFY_KEYS]} captured, "
            f"{[e[k] for k in CERTIFY_KEYS]} eager, differing {differ or 'none'}; the candidate "
            f"{e['ms_per_frame']:.3f} -> {c['ms_per_frame']:.3f} ms/frame, the truth "
            f"{e['ref_ms_per_frame']:.3f} -> {c['ref_ms_per_frame']:.3f} ms/frame (eager -> "
            f"captured), the reference's frame busy {e['busy']:.3f} -> {c['busy']:.3f}")
        if differ:
            raise AssertionError(f"certify {name}: captured relMSEs differ from eager: {differ}")
    return paths, stats


def graph_or_core(step, frames, uniforms):
    """``frames`` frames of ``step(state, uniforms) -> (state, out)`` from
    ``step(None, None)``'s initial state; returns (state, out, host ms a
    frame with each frame synced, K1 launches a frame, its alpha walks
    among them)."""
    k1_walks = lambda: launches()["woop_nearest"] + launches()["woop_nearest_alpha"]
    state = step(None, None)
    ms, k1, out = [], [], None
    for i in range(frames):
        before = k1_walks()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = step(state, uniforms._replace(frame=i))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        k1.append(k1_walks() - before)
    return state, out, ms, k1


def graph_step(graph):
    return lambda st, u: graph.init_state() if st is None else graph.run(st, {"uniforms": u})


def core_step(accel, atlas, config, icfg, dev):
    from merian_quake_tpu_torch.renderer import frame_core, init_state

    return lambda st, u: (init_state(config, icfg, device=dev) if st is None
                          else frame_core(accel, atlas, u, config, st, mcpg_config=icfg))


def image_reading(a, b):
    """(share of pixels within PIX_TOL, mean |d|) of two images or
    per-pixel state fields."""
    d = (a - b).abs().reshape(a.shape[0], a.shape[1], -1)
    return float((d.amax(-1) <= PIX_TOL).float().mean()), float(d.mean())


def flagship_pairs(gst, gout, fst, fout):
    """The flagship graph's outputs and SVGF histories beside frame_core's."""
    pairs = {"hud/ldr": (gout[("hud", "out")], fout["ldr"]),
             "add/hdr": (gout[("add", "out")], fout["hdr"])}
    for node, field in (("denoiser", "svgf"), ("volume_denoiser", "volume_svgf")):
        for k in gst["nodes"][node]._fields:
            pairs[f"{field}.{k}"] = (getattr(gst["nodes"][node], k), getattr(getattr(fst, field), k))
    return pairs


def phase27(dev, smi, city_scene):
    """The frame graph at 1080p: res/pt_graph.json on city against
    frame_core (6 frames, 5 K1 a frame); flagship_graph_config() on the
    fogged court with config5's render setup against frame_core (9
    frames): the same K1 launches and synchronizing calls a frame, and
    in the default mode the HUD and add outputs and both SVGF histories
    equal; the flagship on city (MCPG, denoise, no
    volume) with one steady frame under set_sync_debug_mode("error")."""
    import os

    from merian_quake_tpu_torch.graph import Graph
    from merian_quake_tpu_torch.graph.nodes import GraphContext, flagship_graph_config
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig

    bundle, accel, config = city_scene
    paths, stats = {}, {}
    res = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "res")
    g = Graph.from_config(os.path.join(res, "pt_graph.json"),
                          GraphContext(accel, bundle.atlas, config, device=dev))
    reset_launches()
    _, gout, g_ms, g_k1 = graph_or_core(graph_step(g), 6, bundle.uniforms)
    paths["graph_pt_city"] = launches()
    _, fout, f_ms, f_k1 = graph_or_core(core_step(accel, bundle.atlas, config, None, dev), 6,
                                        bundle.uniforms)
    d = float((gout[("tonemap", "out")] - fout["ldr"]).abs().max())
    want = [1 + SPP * (MPL - 1)] * 6
    log(f"phase 27 graph res/pt_graph.json city {W}x{H} [{smi}]: frames 2-5 "
        f"{np.mean(g_ms[2:]):.2f} ms/frame against frame_core's {np.mean(f_ms[2:]):.2f}; K1 a frame "
        f"{g_k1} (frame_core {f_k1}); tonemap against frame_core's ldr max |d| {d:.3e} (bound "
        f"{GRAPH_PT_ATOL}); launches { {k: v for k, v in paths['graph_pt_city'].items() if v} }")
    if g_k1 != want or f_k1 != want or d > GRAPH_PT_ATOL:
        raise AssertionError("the PT graph differs from frame_core")
    stats["pt_city"] = {"ms": float(np.mean(g_ms[2:])), "frame_core_ms": float(np.mean(f_ms[2:])),
                        "max_abs_ldr": d}

    # the flagship graph on the fogged court, config5's render setup, in
    # the default mode: the same launches (4 alpha walks) and host reads a
    # frame (none in the alpha loop), and the
    # HUD, add and both SVGF histories equal frame_core's bit for bit (the
    # replay's scan repeats itself since F7's repair, ops/segments.py::
    # scan_rows)
    c_bundle, c_accel, c_cfg = court(dev, FOG_MU_T)
    c_cfg = c_cfg._replace(integrator="mcpg", denoise=True)
    mcfg = MCPGConfig(volume=VolumeConfig(volume_spp=1))
    g = Graph.from_config(flagship_graph_config(), GraphContext(
        c_accel, c_bundle.atlas, c_cfg, mcpg_config=mcfg, device=dev))
    reset_launches()
    gst, gout, g_ms, g_k1 = graph_or_core(graph_step(g), 9, c_bundle.uniforms)
    paths["graph_flagship_court"] = launches()
    core = core_step(c_accel, c_bundle.atlas, c_cfg, mcfg, dev)
    fst, fout, f_ms, f_k1 = graph_or_core(core, 9, c_bundle.uniforms)
    pairs = flagship_pairs(gst, gout, fst, fout)
    spread = {k: image_reading(x, y) for k, (x, y) in pairs.items()}
    unequal = [k for k, (x, y) in pairs.items() if not torch.equal(x, y)]
    # frame 9's synchronizing calls; the process's first call in the
    # "warn" mode adds one of torch's own, so frame_core goes first and
    # again after the graph
    u9 = c_bundle.uniforms._replace(frame=9)
    sync_sites(lambda: core(fst, u9))
    _, g_sync = sync_sites(lambda: g.run(gst, {"uniforms": u9}))
    _, f_sync = sync_sites(lambda: core(fst, u9))
    in_loop = [x for x in g_sync + f_sync if x.split(":")[0] in ("intersect.py", "woop.py")]
    if (g_k1 != f_k1 or g_k1 != [4] * 9 or sorted(set(g_sync)) != sorted(set(f_sync))
            or len(g_sync) != len(f_sync) or in_loop):
        raise AssertionError(f"the flagship graph's launches or host reads differ from frame_core's "
                             f"or are not 4 alpha walks and no read in the alpha loop: "
                             f"K1 {g_k1} against {f_k1}, synchronizing calls at {g_sync} against "
                             f"{f_sync}")
    log(f"phase 27 graph flagship court fog mcpg + volume denoise {W}x{H} spp {c_cfg.spp} [{smi}]: "
        f"frames 6-8 {np.mean(g_ms[6:]):.1f} ms/frame against frame_core's {np.mean(f_ms[6:]):.1f}; "
        f"K1 and alpha walks a frame {g_k1} (frame_core {f_k1}); synchronizing calls in frame 9: "
        f"graph "
        f"{len(g_sync)}, frame_core {len(f_sync)}; in the default mode the HUD, add and both SVGF "
        f"histories ({len(pairs)} tensors) bit-identical: {not unequal} (within {PIX_TOL}, "
        f"mean |d|: " + ", ".join(f"{k} {a:.5f} {m:.3e}" for k, (a, m) in spread.items()) + ")")
    if unequal:
        raise AssertionError(f"the flagship graph differs from frame_core in {unequal}")
    stats["flagship_court"] = {"ms": float(np.mean(g_ms[6:])), "frame_core_ms": float(np.mean(f_ms[6:])),
                               "k1_per_frame": g_k1[-1], "syncs": len(g_sync)}

    # the flagship on city (no alpha test, so no host read of the alpha
    # loop): a steady frame makes no synchronizing call, as frame_core's
    # denoised frame makes none (phase 23)
    m_cfg = config._replace(integrator="mcpg", denoise=True)
    g = Graph.from_config(flagship_graph_config(), GraphContext(
        accel, bundle.atlas, m_cfg, mcpg_config=MCPGConfig(), device=dev))
    reset_launches()
    gst, _, g_ms, g_k1 = graph_or_core(graph_step(g), 3, bundle.uniforms)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gst, gout = g.run(gst, {"uniforms": bundle.uniforms._replace(frame=3)})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    paths["graph_flagship_city"] = launches()
    if g_k1 != [3] * 3 or not bool(torch.isfinite(gout[("hud", "out")]).all()):
        raise AssertionError(f"the flagship graph on city: K1 a frame {g_k1}, or a non-finite image")
    log(f"phase 27 graph flagship city mcpg denoise {W}x{H} [{smi}]: frames 1-2 "
        f"{np.mean(g_ms[1:]):.1f} ms/frame, K1 a frame {g_k1}; frame 3 under "
        f"torch.cuda.set_sync_debug_mode('error'): no synchronizing call")
    stats["flagship_city_ms"] = float(np.mean(g_ms[1:]))
    return paths, stats


def to_device(x, dev):
    """Tensors in NamedTuples, tuples, lists and dicts, on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_device(v, dev) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, dev) for v in x)
    return x


def phase28(dev, smi, city_scene, mcpg_city_last, restir_city):
    """Debug views: all 9 MCPG views on phase 16's city state and every
    ReSTIR view on phase 6's at 1080p, finite and of the image's shape; at
    64x36 states made on the CPU, moved to the card: each view the same on
    both (view 3 and its cell keys bit for bit); the port's tracer on a
    captured MCPG frame."""
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.hit import decompress_hit
    from merian_quake_tpu_torch.render.mcpg.debug import (
        DEBUG_VIEWS, grid_cell_seed, render_mcpg_debug,
    )
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.render.restir.debug import DEBUG_VIEWS as RESTIR_VIEWS
    from merian_quake_tpu_torch.render.restir.debug import render_restir_debug
    from merian_quake_tpu_torch.capture import tree_leaves, tree_map
    from merian_quake_tpu_torch.renderer import compile_frame, render_sequence
    from merian_quake_tpu_torch.utils import profiler

    bundle, accel, _ = city_scene
    m_cfg, mcfg, m_uni, m_state, m_out = mcpg_city_last
    r_cfg, r_state, r_out = restir_city
    mcpg_view = lambda s, u, c, st, o: render_mcpg_debug(s, u, c, mcfg, st.mcpg, o["gbuffer"],
                                                         o["irradiance"])
    restir_view = lambda s, c, st, o: render_restir_debug(s, c, st.restir, o["gbuffer"])
    ms = {}
    for kind, views, run in (("mcpg", DEBUG_VIEWS, lambda s: mcpg_view(s, m_uni, m_cfg, m_state, m_out)),
                             ("restir", RESTIR_VIEWS, lambda s: restir_view(s, r_cfg, r_state, r_out))):
        for s in views:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = run(s)
            torch.cuda.synchronize()
            ms[f"{kind} {s}"] = (time.perf_counter() - t0) * 1e3
            if tuple(img.shape) != (H, W, 3) or not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{kind} debug view {s} ({views[s]}): shape "
                                     f"{tuple(img.shape)} or not finite")
    log(f"phase 28 debug views {W}x{H} on phases 16 and 6's states [{smi}]: every view finite, "
        f"ms a view " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))

    small = RenderConfig(width=64, height=36, spp=SPP, max_path_length=MPL)
    readings = []
    for kind, icfg, views in (("mcpg", mcfg, DEBUG_VIEWS), ("restir", ReSTIRConfig(), RESTIR_VIEWS)):
        cfg = small._replace(integrator=kind)
        st, out = render_sequence(city(device="cpu"), cfg, frames=3, mcpg_config=icfg, device="cpu")
        uni = city(device="cpu").uniforms._replace(frame=2)
        st_d, out_d, uni_d = to_device(st, dev), to_device(out, dev), to_device(uni, dev)
        for s in views:
            if kind == "mcpg":
                a, b = mcpg_view(s, uni, cfg, st, out), mcpg_view(s, uni_d, cfg, st_d, out_d)
            else:
                a, b = restir_view(s, cfg, st, out), restir_view(s, cfg, st_d, out_d)
            b = b.cpu()
            same = torch.equal(a, b) if (kind, s) == ("mcpg", 3) else torch.allclose(b, a, **VIEW_TOL)
            readings.append(f"{kind} {s} max |d| {float((a - b).abs().max()):.3e} on "
                            f"{int((a != b).any(-1).sum())} pixels")
            if not same:
                raise AssertionError(f"{kind} debug view {s} differs between the CPU and the card: "
                                     f"{readings[-1]}")
        if kind == "mcpg":
            hit = decompress_hit(out["gbuffer"].hits)
            keys = grid_cell_seed(hit.pos, uni.cam_x, mcfg)
            keys_d = grid_cell_seed(hit.pos.to(dev), uni_d.cam_x, mcfg).cpu()
            if not torch.equal(keys, keys_d):
                raise AssertionError("view 3's cell keys differ between the CPU and the card")
    log(f"phase 28 debug views 64x36, a CPU state on the CPU and on the card: view 3 and its "
        f"cell keys bit for bit, the others within {VIEW_TOL}; " + "; ".join(readings))

    # the port's tracer on the captured frame: two compiled frames from one
    # state, the second's replays recorded, stay bit-equal, and the recorded
    # lead and top-level stages tile each replay
    clone = lambda x: tree_map(torch.clone, x)
    runs = {}
    for recording in (False, True):
        cf = compile_frame(accel, bundle.atlas, m_cfg, clone(m_state), mcfg)
        cf(m_uni._replace(frame=m_uni.frame + 1))
        torch.cuda.synchronize()
        prev = profiler.install(profiler.Profiler(enabled=recording))
        try:
            for k in range(2, 5):
                st, out = cf(m_uni._replace(frame=m_uni.frame + k))
                torch.cuda.synchronize()
            summary = profiler.summary()
        finally:
            profiler.install(prev)
        runs[recording] = (clone(st), {k: v for k, v in out.items() if k != "gbuffer"}, summary)
        del cf
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(runs[False][:2]),
                                                 tree_leaves(runs[True][:2])))
    summary = runs[True][2]
    spans = summary["spans"]
    n = max(summary["frames"], 1)
    tops = [k for k, v in spans.items() if v["parent"] is None]
    tiled = sum(spans[k]["ms"] for k in tops) / n
    replay = summary["replays"]["ms"] / max(summary["replays"]["frames"], 1)
    stages = {k: round(v["ms"] / n, 3) for k, v in spans.items()}
    log(f"phase 28 tracer on a captured 1080p city MCPG frame [{smi}]: {summary['frames']} "
        f"frames recorded, recorded and not bit-equal {same}; ms a frame {stages}; replay call "
        f"to graph end {replay:.3f} ms, lead + top-level {tiled:.3f} ms; counters a frame "
        + ", ".join(f"{k} {v / n:.1f}" for k, v in sorted(summary["counters"].items())))
    want = {"replay.lead", "replay.inputs", "replay.launch", "gbuffer", "mcpg.pack",
            "mcpg.surface", "mcpg.surface.seg0", "mcpg.update", "post", "carry"}
    if not (same and summary["frames"] == 3 and want <= set(spans)
            and abs(tiled - replay) < 0.1 and runs[False][2]["frames"] == 0):
        raise AssertionError("the tracer changed the captured frame, missed a stage or does "
                             "not tile the replay")
    return {"view_ms": ms, "tracer_ms": stages, "tracer_replay_ms": replay}
