#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives merian_quake_tpu_torch's main path — the path-traced frame of
the procedural ``city`` scene (16,640 triangles) at 1920×1080, 2 spp,
max path length 3 — on the first CUDA device, after building and
checking its hand-written kernel. Phases, one line each:

1. device: the card's name and power limit (nvidia-smi), and the time to
   build K1 (csrc/woop_nearest.cu) with nvcc for sm_90a;
2. K1 against its plain PyTorch version on the card: a random soup with
   half misses; 65,536-ray subsets of city's 1080p primary rays and of
   one sorted bounce population (t_min = 0 and 1e-3); then the whole
   2,073,600-ray primary and bounce populations (t_min = 0 and 1e-3), as
   the frame launches K1 on them, with both timed by CUDA events in
   turns at t_min = 0;
3. the slice: 6 frames on the card, K1 launched exactly 5 times a frame,
   finite outputs, cold and steady ms/frame and Mrays/s;
4. the same frames at 64×36 on the CPU (Möller–Trumbore oracle) and on
   the card (K1): the LDR images agree within the slice test's tolerance.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failure raises before it. Without a
CUDA device the script fails at once and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCE = "merian_quake_tpu_torch/csrc/woop_nearest.cu"
REPLACES = "merian_quake_tpu/accel/woop.py:289"
W, H, SPP, MPL = 1920, 1080, 2, 3
SUBSET = 65536
# K1 vs its plain version: tri equal on at least this share of rays, and
# where tri differs both hits at the same t. K1 rounds each multiply and
# add like the plain version, so the runs so far were identical.
TRI_EQUAL_MIN = 0.99999
T_RTOL = 1e-5
# CPU vs card LDR agreement (the slice test's tolerance)
PIX_TOL, PIX_SHARE, MEAN_TOL = 1e-3, 0.995, 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


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


def check_k1(name, kernel_out, plain_out):
    """Hold K1's (t, tri) against its plain version's on the same rays."""
    (t_k, tri_k), (t_r, tri_r) = kernel_out, plain_out
    torch.cuda.synchronize()
    eq = tri_k == tri_r
    share = float(eq.float().mean())
    hit = (tri_r >= 0) | (tri_k >= 0)
    rel = (t_k - t_r).abs() / torch.clamp_min(t_r.abs(), 1e-6)
    worst_rel = float(rel[hit].max()) if bool(hit.any()) else 0.0
    max_abs = float((t_k - t_r)[hit].abs().max()) if bool(hit.any()) else 0.0
    log(
        f"phase 2 {name}: rays={t_k.numel()} hits={int(hit.sum())} "
        f"tri_equal={share:.7f} t_max_rel_err={worst_rel:.3e} "
        f"t_max_abs_err={max_abs:.3e}"
    )
    if share < TRI_EQUAL_MIN:
        raise AssertionError(f"{name}: tri equal on {share} < {TRI_EQUAL_MIN}")
    if worst_rel > T_RTOL:
        raise AssertionError(f"{name}: t differs by rel {worst_rel} > {T_RTOL}")
    return max_abs


def compare_k1(name, args, woop):
    """Run K1 and its plain version on the same inputs; check tri/t."""
    return check_k1(
        name, woop.woop_nearest(*args), woop.intersect_woop_reference(args[0], args[1])
    )


def primary_rays(bundle, accel, dev):
    from merian_quake_tpu_torch.ops import camera
    from merian_quake_tpu_torch.render import layout

    u = bundle.uniforms
    px, py = layout.gen_pixels(W, H, device=dev)
    d = camera.ray_dir(px.float(), py.float(), W, H, u.cam_u, u.cam_w, u.fov_tan_half)
    return u.cam_x.expand_as(d).contiguous(), d


def bounce_rays(bundle, accel, config, dev):
    """First bounce of the path tracer at frame 0 (render/pt.py)."""
    from merian_quake_tpu_torch.ops import bsdf, linalg, rng
    from merian_quake_tpu_torch.render import layout
    from merian_quake_tpu_torch.render.gbuffer import render_gbuffer
    from merian_quake_tpu_torch.render.hit import decompress_hit

    gbuf = render_gbuffer(accel, bundle.atlas, bundle.uniforms, config)
    cur = decompress_hit(gbuf.hits)
    px, py = layout.gen_pixels(W, H, device=dev)
    state = rng.seed_pixel(px, py, 0, config.seed)
    _, u3 = rng.uniform3(state)
    alpha = bsdf.roughness_to_alpha(cur.roughness)
    wo = bsdf.sample(cur.wi, cur.normal, alpha, u3)
    below = (linalg.dot(wo, cur.normal) <= 1e-3) | (linalg.dot(wo, cur.geo_normal) <= 1e-3)
    live = (cur.albedo >= 1e-7).any(-1) & ~below
    t_max = torch.where(live, 1e4, -1.0)
    return (cur.pos - cur.wi * 1e-3).contiguous(), wo.contiguous(), t_max


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from merian_quake_tpu_torch import kernels
    from merian_quake_tpu_torch.accel import build_accel, woop
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig, build_scene_from_soup
    from merian_quake_tpu_torch.renderer import init_state, render_frame, render_sequence

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- phase 1: device + build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    kernels.load_library("woop_nearest")
    build_s = time.perf_counter() - t0
    with open(kernels.library_path("woop_nearest") + ".log") as f:
        ptxas = " | ".join(line.strip() for line in f if "ptxas info" in line)
    log(f"phase 1 device: {kind} x{count} [{smi}] torch {torch.__version__} "
        f"cuda {torch.version.cuda}; K1 build {build_s:.2f} s ({ptxas})")

    # ---- phase 2: K1 vs plain version ----
    rng = np.random.default_rng(1337)
    n_tri = 256
    c = rng.uniform(-40, 40, (n_tri, 1, 3))
    tri = c + rng.uniform(-8, 8, (n_tri, 3, 3))
    soup = build_scene_from_soup(
        tri[:, 0].astype(np.float32), tri[:, 1].astype(np.float32),
        tri[:, 2].astype(np.float32), device=dev,
    )
    acc_soup = build_accel(soup)
    n = 512
    o = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[: n // 2] = 500.0
    d[: n // 2] = np.abs(d[: n // 2])
    o_t, d_t = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    full = lambda v, k: torch.full((k,), v, device=dev)
    max_abs = [compare_k1(
        "random soup", woop.k1_inputs(acc_soup, o_t, d_t, full(0.0, n), full(1e4, n)), woop
    )]

    bundle = city(device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    config = RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL, features=feats)
    n_full = W * H
    po, pd = primary_rays(bundle, accel, dev)
    bo, bd, bt = bounce_rays(bundle, accel, config, dev)
    perm = woop.sort_perm(accel, bo, bd, bt)
    bo, bd, bt = bo[perm].contiguous(), bd[perm].contiguous(), bt[perm].contiguous()
    mid = slice(n_full // 2, n_full // 2 + SUBSET)
    max_abs.append(compare_k1("city primary 65536", woop.k1_inputs(
        accel, po[mid].contiguous(), pd[mid].contiguous(), full(0.0, SUBSET), full(1e4, SUBSET)
    ), woop))
    for t_min in (0.0, 1e-3):
        max_abs.append(compare_k1(f"city bounce 65536 t_min={t_min}", woop.k1_inputs(
            accel, bo[mid].contiguous(), bd[mid].contiguous(), full(t_min, SUBSET),
            bt[mid].contiguous(),
        ), woop))

    # full 1080p populations: K1 and the plain version timed in turns;
    # the warm-up outputs are held against each other
    timings = {}
    for name, args in (
        ("primary", woop.k1_inputs(accel, po, pd, full(0.0, n_full), full(1e4, n_full))),
        ("bounce", woop.k1_inputs(accel, bo, bd, full(0.0, n_full), bt)),
    ):
        ref = lambda: woop.intersect_woop_reference(args[0], args[1])
        k1 = lambda: woop.woop_nearest(*args)
        max_abs.append(check_k1(f"city {name} {n_full} t_min=0.0", k1(), ref()))
        r1 = cuda_time(ref, 1)
        k_1 = cuda_time(k1, 10)
        k_2 = cuda_time(k1, 10)
        r2 = cuda_time(ref, 1)
        timings[name] = ((k_1 + k_2) / 2, (r1 + r2) / 2)
        log(f"phase 2 timing {name} {n_full} rays [{smi}]: K1 {k_1:.3f} / {k_2:.3f} ms, "
            f"plain {r1:.1f} / {r2:.1f} ms")
    max_abs.append(compare_k1(f"city bounce {n_full} t_min=0.001", woop.k1_inputs(
        accel, bo, bd, full(1e-3, n_full), bt), woop))

    # ---- phase 3: the slice on the card ----
    woop.woop_nearest.launches = 0
    state = init_state(config, device=dev)
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
    launches = woop.woop_nearest.launches
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
    log(f"phase 3 slice city {W}x{H} spp {SPP} mpl {MPL} [{smi}]: K1 launches {launches}; "
        f"cold {frame_ms[0]:.1f} ms, steady {steady:.1f} ms/frame "
        f"(frames {', '.join(f'{x:.1f}' for x in frame_ms)}), "
        f"{rays / steady / 1e3:.2f} Mrays/s; ldr mean {float(out['ldr'].mean()):.4f}")

    # ---- phase 4: CPU oracle vs card K1 ----
    small = RenderConfig(width=64, height=36, spp=SPP, max_path_length=MPL)
    _, out_cpu = render_sequence(city(), small, frames=3, device="cpu")
    _, out_gpu = render_sequence(city(), small, frames=3, device=dev)
    diff = (out_cpu["ldr"] - out_gpu["ldr"].cpu()).abs()
    share = float((diff.amax(-1) <= PIX_TOL).float().mean())
    mean = float(diff.mean())
    log(f"phase 4 cpu vs cuda 64x36 x3 frames: pixels within {PIX_TOL} {share:.5f}, "
        f"mean |d| {mean:.3e}, max |d| {float(diff.max()):.3e}")
    if share < PIX_SHARE or mean >= MEAN_TOL:
        raise AssertionError("CPU and card LDR images disagree")

    k_ms = (timings["primary"][0] * 1 + timings["bounce"][0] * 4) / 5
    p_ms = (timings["primary"][1] * 1 + timings["bounce"][1] * 4) / 5
    print(json.dumps({"kernels": [{
        "name": "woop_nearest", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max(max_abs),
        "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
