"""What the phases share: the frame size and tolerances, the log, the
launch counters, CUDA-event timing, the bounds, the exact comparisons,
and the frame runs more than one module drives."""
from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


W, H, SPP, MPL = 1920, 1080, 2, 3
SUBSET = 65536

# the bound: H100 SXM data-sheet rates (FP32 outside the tensor cores, HBM3).
# 67 TFLOP/s counts an FMA as two operations; the kernels round every
# multiply and add on its own (no FMA), so each is one instruction in an
# FMA's issue slot, and they issue at most half that many a second.
FP32_RATE, HBM_RATE = 67e12, 3.35e12
FP32_ISSUE_RATE = FP32_RATE / 2
# FP32 multiplies and adds a (ray, triangle) pair: the Woop nearest test,
# the Woop any-hit test, Möller–Trumbore (with its reciprocal)
OPS_NEAREST, OPS_ANY, OPS_MT = 42, 46, 46
# CPU vs card LDR agreement (the slice test's tolerance)
PIX_TOL, PIX_SHARE, MEAN_TOL = 1e-3, 0.995, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches() -> None:
    from merian_quake_tpu_torch.accel import dense, woop

    woop.woop_nearest.launches = woop.woop_any.launches = 0
    woop.woop_stream.launches = woop.woop_stream.anyhit_launches = 0
    dense.mt_dense.launches = 0
    woop.target_keys.launches = woop.te_union.launches = woop.woop_list.launches = 0
    woop.visit_list.launches = 0
    woop.woop_list.node_launches = woop.woop_list.compact_launches = 0
    woop.woop_list.anyhit_launches = 0
    woop.woop_nearest_alpha.launches = woop.woop_stream_alpha.launches = 0


def launches() -> dict:
    from merian_quake_tpu_torch.accel import dense, woop

    return {"woop_nearest": woop.woop_nearest.launches, "woop_any": woop.woop_any.launches,
            "woop_stream": woop.woop_stream.launches,
            "woop_stream_any": woop.woop_stream.anyhit_launches,
            "mt_dense": dense.mt_dense.launches, "target_keys": woop.target_keys.launches,
            "te_union": woop.te_union.launches, "visit_list": woop.visit_list.launches,
            "woop_list": woop.woop_list.launches,
            "woop_list_nodes": woop.woop_list.node_launches,
            "woop_list_compact": woop.woop_list.compact_launches,
            "woop_list_any": woop.woop_list.anyhit_launches,
            "woop_nearest_alpha": woop.woop_nearest_alpha.launches,
            "woop_stream_alpha": woop.woop_stream_alpha.launches}


def bound_ms(ops: float, nbytes: float):
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = ops / FP32_ISSUE_RATE, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def woop_work(kernel, args, any_ops=False, **kw):
    """Run a Woop kernel once with its per-CTA pair counts; returns (ops,
    bytes) of that launch: the pairs it tested times the FP32 operations
    a pair (any-hit's with ``any_ops``), and the rays in, results out,
    warm start, table rows (48 B a triangle) and bounds read once."""
    rays, w, lo = args[0], args[1], args[2]
    n = rays.shape[1]
    counts = torch.zeros(n // 128, dtype=torch.int64, device=rays.device)
    kernel(*args, counts=counts, **kw)
    out = n if any_ops else 8 * n
    warm = n if kw.get("occluded_in") is not None else 0
    nbytes = n * 32 + out + warm + (w.shape[0] // 3) * 48 + lo.shape[0] * 24
    return float(counts.sum()) * (OPS_ANY if any_ops else OPS_NEAREST), nbytes


def trace_split(phase, name, kernel, args, smi, **kw):
    """Launch K1's or K3's profile instance once and print where its
    cycles go (shares of the cycles summed over all warps, woop.PROF_FIELDS),
    the pairs it tested, the warp-issued pairs and the lane use = pairs / 32
    / warp-issued pairs. Returns that record."""
    from merian_quake_tpu_torch.accel import woop

    n = args[0].shape[1]
    prof = torch.zeros((n // 128, len(woop.PROF_FIELDS)), dtype=torch.int64,
                       device=args[0].device)
    kernel(*args, counts=prof, **kw)
    torch.cuda.synchronize()
    rec = dict(zip(woop.PROF_FIELDS, (int(x) for x in prof.sum(0))))
    total = max(rec["total"], 1)
    rec["lane_use"] = rec["pairs"] / 32 / max(rec["warp_pairs"], 1)
    rec["shares"] = {k: rec[k] / total for k in woop.PROF_FIELDS[:5]}
    shares = ", ".join(f"{k} {v:.4f}" for k, v in rec["shares"].items())
    log(f"phase {phase} split {name} [{smi}]: cycles {rec['total']} over all warps ({shares} of "
        f"them); pairs tested {rec['pairs']}, warp-issued pairs {rec['warp_pairs']}, lane use "
        f"{rec['lane_use']:.4f}")
    return rec


def cuda_time(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed_call(fn):
    """(fn()'s output, the ms it took on the CUDA-event clock)."""
    out = []
    return out, cuda_time(lambda: out.append(fn()), 1)


def check_k2(name, kernel_out, plain_out, phase=5):
    """Hold an any-hit kernel's occlusion against another's: equal on every
    ray. Returns the largest |difference| over the 0/1 occlusion values."""
    torch.cuda.synchronize()
    diff = (kernel_out.float() - plain_out.float()).abs()
    differ = int((diff > 0).sum())
    log(f"phase {phase} {name}: rays={kernel_out.numel()} occluded={int(plain_out.sum())} "
        f"differ={differ}")
    if differ:
        raise AssertionError(f"{name}: the two sweeps differ on {differ} rays")
    return float(diff.max())


def check_exact(phase, name, kernel_out, other_out):
    """Hold a nearest-hit kernel's (t, tri) against another's: bit for bit
    on every ray. Returns the largest |t difference| (0)."""
    (t_k, tri_k), (t_r, tri_r) = kernel_out, other_out
    torch.cuda.synchronize()
    tri_differ = int((tri_k != tri_r).sum())
    t_differ = int((t_k != t_r).sum())
    log(f"phase {phase} {name}: rays={t_k.numel()} hits={int((tri_r >= 0).sum())} "
        f"tri differ={tri_differ} t differ={t_differ}")
    if tri_differ or t_differ:
        raise AssertionError(f"{name}: tri differs on {tri_differ} rays, t on {t_differ}")
    return float((t_k - t_r).abs().max())


def with_prepass(accel, o, d, t_min, t_max, sort_rays=False, schedule=None):
    """``woop.intersect_woop_any`` as the JAX package runs it (F4's other
    way): K2 on the proxy table first, then the route's shadow sweep
    warm-started by it. The visibility calls of a frame take no sort."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.ops.linalg import as_f32

    if sort_rays:
        raise AssertionError("with_prepass: no sorted visibility trace")
    n = o.shape[0]
    t_min_b = as_f32(t_min, o).expand(n).contiguous()
    t_max_b = as_f32(t_max, o).expand(n).contiguous()
    rays, proxy, shadow = woop.k2_inputs(accel, o, d, t_min_b, t_max_b)
    pre = None if proxy is None else woop.woop_any(rays, *proxy)
    return woop.sweep_any(rays, *shadow, schedule, pre)[:n]


def restir_run(bundle, accel, cfg, dev, frames=6, schedule=None, prepass=False):
    """``frames`` ReSTIR frames from a fresh state, the visibility traces as
    the card's route runs them or, ``prepass``, with the proxy pre-pass
    (:func:`with_prepass`); returns (ms a frame, each frame's ldr)."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    rcfg = ReSTIRConfig()
    state = init_state(cfg, rcfg, device=dev)
    route = woop.intersect_woop_any
    woop.intersect_woop_any = with_prepass if prepass else route
    try:
        frame_ms, ldr = [], []
        for i in range(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=i), cfg,
                                      state, rcfg, schedule=schedule)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            ldr.append(out["ldr"])
    finally:
        woop.intersect_woop_any = route
    return frame_ms, ldr


def prepass_ab(phase, path, bundle, accel, cfg, dev, smi, schedule=None):
    """F4 on frames: 8 ReSTIR frames without the proxy pre-pass (the
    card's route) and with it, in turns (without, with, with, without,
    twice); every frame's LDR the same both ways (the pre-pass changes no
    ray). Returns {"without_ms", "with_ms"}: the means of frames 2-7."""
    steady, first = {False: [], True: []}, {}
    for prepass in (False, True, True, False) * 2:
        frame_ms, ldr = restir_run(bundle, accel, cfg, dev, frames=8, schedule=schedule,
                                   prepass=prepass)
        steady[prepass].append(float(np.mean(frame_ms[2:])))
        first.setdefault(prepass, ldr)
    same = all(torch.equal(a, b) for a, b in zip(first[False], first[True]))
    diff = (first[False][-1] - first[True][-1]).abs()
    share = float((diff.amax(-1) <= PIX_TOL).float().mean())
    log(f"phase {phase} F4 {path} {W}x{H} [{smi}]: steady ms/frame (frames 2-7) without the "
        f"proxy pre-pass {' / '.join(f'{x:.2f}' for x in steady[False])} (mean "
        f"{np.mean(steady[False]):.2f}), with it {' / '.join(f'{x:.2f}' for x in steady[True])} "
        f"(mean {np.mean(steady[True]):.2f}); ldr bit-identical on every frame {same}, frame 7 "
        f"pixels within {PIX_TOL} {share:.5f}")
    if share < PIX_SHARE:
        raise AssertionError(f"{path}: frames with and without the pre-pass differ")
    return {"without_ms": float(np.mean(steady[False])), "with_ms": float(np.mean(steady[True]))}


def mcpg_scene_config(config):
    """A scene's 1080p config as the MCPG frame's, and ``MCPGConfig()``."""
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig

    return config._replace(integrator="mcpg"), MCPGConfig()


def check_mcpg_finite(path, state, out):
    for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]), ("irradiance", out["irradiance"]),
                    ("accum_irradiance", state.accum_irradiance),
                    ("accum_direct", state.accum_direct), ("accum_albedo", state.accum_albedo),
                    ("mc.f", state.mcpg.mc.f), ("lc.irr", state.mcpg.lc.irr)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{path} {name} is not finite")
    if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
        raise AssertionError(f"{path} ldr has the wrong shape or is constant")


def frames_run(phase, path, dev, bundle, accel, config, icfg, frames, window, expect, smi, rays,
               schedule=None, per_frame=None):
    """``frames`` frames at 1080p from an empty state with the launch
    counts set to 0 just before and read just after, each frame's launches
    held to ``expect`` exactly; finite outputs; ``rays`` a frame for the
    rate. ``per_frame`` (label, fn of the state) is read after each frame,
    outside the timed region, and printed. Returns (state, out, the path's
    launches, frame ms, the per-frame readings)."""
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    state = init_state(config, icfg, device=dev)
    reset_launches()
    frame_ms, seen = [], []
    for i in range(frames):
        before = launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=i), config,
                                  state, icfg, schedule=schedule)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        got = {k: v - before[k] for k, v in launches().items()}
        if got != {**{k: 0 for k in got}, **expect}:
            raise AssertionError(f"{path} frame {i}: launched {got}, expected {expect}")
        if per_frame is not None:
            seen.append(per_frame[1](state))
    counts = launches()
    for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]), ("irradiance", out["irradiance"])):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{path} {name} is not finite")
    if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
        raise AssertionError(f"{path} ldr has the wrong shape or is constant")
    lo, hi = window
    steady = float(np.mean(frame_ms[lo:hi]))
    log(f"phase {phase} {path} {W}x{H} spp {config.spp} mpl {config.max_path_length} "
        f"schedule={tuple(schedule) if schedule else None} [{smi}]: launches "
        f"{ {k: v for k, v in counts.items() if v} }; cold {frame_ms[0]:.1f} ms, mean of frames "
        f"{lo}-{hi - 1} {steady:.1f} ms/frame, {rays / steady / 1e3:.2f} Mrays/s (frames "
        f"{', '.join(f'{x:.1f}' for x in frame_ms)}); "
        + (f"per frame {per_frame[0]} {seen}; " if per_frame is not None else "")
        + f"ldr mean {float(out['ldr'].mean()):.4f}")
    return state, out, counts, frame_ms, seen


def mcpg_frames(phase, path, dev, bundle, accel, config, mcfg, frames, window, expect, smi,
                schedule=None, rays=W * H * (1 + SPP * (MPL - 1))):
    """``frames`` MCPG frames through :func:`frames_run`, printing per frame
    the count of chain states with sum_w > 0 and ``lc_updates_applied``;
    the guiding state finite. Returns (state, out, the path's launches,
    frame ms, (states per frame, lc_updates_applied per frame))."""
    learned = ("(states with sum_w > 0, lc_updates_applied)",
               lambda s: (int((s.mcpg.mc.sum_w > 0).sum()), int(s.mcpg.lc_updates_applied)))
    state, out, counts, frame_ms, seen = frames_run(
        phase, path, dev, bundle, accel, config, mcfg, frames, window, expect, smi, rays,
        schedule=schedule, per_frame=learned)
    check_mcpg_finite(path, state, out)
    return state, out, counts, frame_ms, tuple(list(x) for x in zip(*seen))


def guided_population(bundle, accel, config, mcfg, state, frame):
    """One more MCPG frame with the surface pass's traces recorded: returns
    (the new state, [(origin, direction, t_max) of each bounce segment])
    — the rays as the frame hands them to K1 or K3 (dead lanes t_max -1)."""
    from merian_quake_tpu_torch.render.mcpg import surface
    from merian_quake_tpu_torch.render.trace import T_MAX
    from merian_quake_tpu_torch.renderer import render_frame

    plain, seen = surface.trace_ray, []

    def record(acc, atlas, uniforms, pos, wi, *a, active=None, **k):
        seen.append((pos.contiguous(), wi.contiguous(),
                     torch.where(active, T_MAX, -1.0).contiguous()))
        return plain(acc, atlas, uniforms, pos, wi, *a, active=active, **k)

    surface.trace_ray = record
    try:
        state, _ = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=frame), config,
                                state, mcfg)
    finally:
        surface.trace_ray = plain
    if len(seen) != MPL - 1 or seen[0][0].shape[0] != SPP * W * H:
        raise AssertionError("the surface pass traced other populations than spp·W·H a segment")
    return state, seen


# the fogged court's extinction: optically thin over the court's depth
# (the camera sees 100-900 units of fog), so the medium scatters visibly
FOG_MU_T = 0.002


def sync_sites(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")`` and
    return (its result, the file:line of each synchronizing call)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, [f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in seen
                 if "synchroniz" in str(w.message)]


def scene_1080(bundle, **kw):
    """A bundle's accel and its 1080p config (``kw`` on top)."""
    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.types import RenderConfig

    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    return accel, RenderConfig(width=W, height=H, features=feats, **kw)


# the least span, ms, of the profiled eager frames and of the replays
PROFILE_MS = 250.0


def differing_leaves(a, b) -> list:
    """Indices of the tensors of ``a`` and ``b`` (same structure) that are
    not equal bit for bit; ["structure"] if the structures differ."""
    from merian_quake_tpu_torch.capture import skeleton, tree_leaves

    if skeleton(a) != skeleton(b):
        return ["structure"]
    return [i for i, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b)))
            if not torch.equal(x, y)]


def profiled(fn, n):
    """(device ms a call, wall ms a call, device busy share) of ``n`` calls of
    ``fn`` under torch.profiler, device activity only: the device time is
    the sum of the kernels' and copies' own time, the wall the host clock
    around the calls and a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    total = sum(dev_us(e) for e in prof.key_averages() if e.device_type.name != "CPU") / 1e3
    return total / n, wall / n, total / wall


def leaf_diff(label, got: dict, ref: dict, phase: int = 40) -> dict:
    """Each leaf of ``got`` against ``ref``: (elements whose bits differ,
    the largest |difference|, the largest relative one). Logs the leaves
    that differ."""
    torch.cuda.synchronize()
    bits = lambda x: x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x
    out = {}
    for k, b in ref.items():
        a = got[k]
        differ = int((bits(a) != bits(b)).sum())
        d = (a.double() - b.double()).abs().nan_to_num(0.0)
        out[k] = (differ, float(d.max()) if differ else 0.0,
                  float((d / b.abs().clamp_min(1e-30)).nan_to_num(0.0).max()) if differ else 0.0)
    bad = {k: v for k, v in out.items() if v[0]}
    log(f"phase {phase} {label}: " + (f"all {len(ref)} leaves bit for bit" if not bad else
                                 f"DIFFER (elements, max abs, max rel) {bad}"))
    return out


def card() -> tuple:
    """The first CUDA device and nvidia-smi's line of its name and power
    limit; exits where there is no card."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return torch.device("cuda", 0), smi
