#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives merian_quake_tpu_torch's two paths on the procedural ``city``
scene (16,640 triangles) at 1920×1080 — the path-traced frame (2 spp,
max path length 3) and the ReSTIR DI frame (``ReSTIRConfig()``) — on the
first CUDA device, after building and checking their hand-written
kernels, K1 (csrc/woop_nearest.cu, nearest hit) and K2
(csrc/woop_any.cu, any hit). Phases, one line each or more:

1. device: the card's name and power limit (nvidia-smi), and the time to
   build K1 and K2 with nvcc for sm_90a (both started together), with
   each kernel's ptxas line;
2. K1 against its plain PyTorch version on the card: a random soup with
   half misses; 65,536-ray subsets of city's 1080p primary rays and of
   one sorted bounce population (t_min = 0 and 1e-3); then the whole
   2,073,600-ray primary and bounce populations (t_min = 0 and 1e-3), as
   the frame launches K1 on them, with both timed by CUDA events in
   turns at t_min = 0;
3. the slice: 6 frames on the card, K1 launched exactly 5 times a frame,
   finite outputs, cold and steady ms/frame and Mrays/s;
4. the same frames at 64×36 on the CPU (Möller–Trumbore oracle) and on
   the card (K1): the LDR images agree within the slice test's tolerance;
5. K2 against its plain PyTorch version on the card, equal on every ray:
   a random soup with half misses and a per-ray t_max; a soup with a sky
   wall in front of an opaque one; a 65,536-ray subset and the whole
   2,073,600-ray population of city's 1080p shade-pass shadow rays
   (gbuffer points to frame-0 reservoir samples) on the proxy table, on
   the shadow table, and on the shadow table warm-started by the proxy
   pre-pass; K2 and the plain version timed with CUDA events in turns;
   then ``trace_visibility`` on the card (K2 + the alpha table through
   K1) against the CPU oracle on a small alpha-grate soup;
6. the ReSTIR slice: 6 frames on the card, exactly 2 K1 and 2 K2
   launches a frame, finite outputs and reservoirs, the largest
   reservoir M above 1 by frame 6, cold and steady ms/frame;
7. 3 ReSTIR frames at 64×36 on the CPU (oracle) and on the card (K1 +
   K2), with defaults and with both bias corrections set to 2 (so that
   all three visibility call sites launch K2): the LDR images agree
   within the slice test's tolerance.

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
K2_SOURCE = "merian_quake_tpu_torch/csrc/woop_any.cu"
K2_REPLACES = "merian_quake_tpu/accel/woop.py:786"
W, H, SPP, MPL = 1920, 1080, 2, 3
SUBSET = 65536
# K1 vs its plain version: tri equal on at least this share of rays, and
# where tri differs both hits at the same t. K1 rounds each multiply and
# add like the plain version, so the runs so far were identical.
TRI_EQUAL_MIN = 0.99999
T_RTOL = 1e-5
# CPU vs card LDR agreement (the slice test's tolerance)
PIX_TOL, PIX_SHARE, MEAN_TOL = 1e-3, 0.995, 1e-4
# trace_visibility on the card (Woop) vs the CPU oracle (Möller–Trumbore):
# the two tests round differently on edges and at t_max, so a grazing
# segment may split; at most 2 in 1,000
VIS_AGREE = 0.998


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


def check_k2(name, kernel_out, plain_out):
    """Hold K2's occlusion against its plain version's: equal on every ray.
    Returns the largest |K2 - plain| over the 0/1 occlusion values."""
    torch.cuda.synchronize()
    diff = (kernel_out.float() - plain_out.float()).abs()
    differ = int((diff > 0).sum())
    log(f"phase 5 {name}: rays={kernel_out.numel()} occluded={int(plain_out.sum())} "
        f"differ={differ}")
    if differ:
        raise AssertionError(f"{name}: K2 and its plain version differ on {differ} rays")
    return float(diff.max())


def shade_rays(bundle, accel, config, dev):
    """The 1080p shade pass's shadow rays at frame 0: gbuffer points to
    the reservoir samples after spatial reuse (render/restir/restir.py;
    the shade pass discards, it never moves, y_pos), packed as
    ``trace_visibility`` packs them."""
    from merian_quake_tpu_torch.render.gbuffer import render_gbuffer
    from merian_quake_tpu_torch.render.hit import decompress_hit
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig, init_restir_state, render_restir

    rconfig = config._replace(integrator="restir")
    gbuf = render_gbuffer(accel, bundle.atlas, bundle.uniforms, rconfig)
    _, rstate = render_restir(accel, bundle.atlas, bundle.uniforms, rconfig, ReSTIRConfig(),
                              init_restir_state(W, H, device=dev), gbuf)
    frm = decompress_hit(gbuf.hits).pos
    wo = rstate.reservoirs.y_pos - frm
    dist = torch.linalg.vector_norm(wo, dim=-1)
    d = wo / torch.clamp_min(dist, 1e-20)[:, None]
    return frm.contiguous(), d.contiguous(), torch.clamp_min(dist - 2e-3, 1e-3).contiguous()


def grate_soup(dev):
    """A box room with two alpha-tested grates (texture alpha in stripes)
    across it and one opaque pillar: the scene has an alpha-only table."""
    from merian_quake_tpu_torch.models.atlas import pack_textures
    from merian_quake_tpu_torch.models.procedural import _const_tex, _SoupBuilder

    grate = _const_tex((120, 120, 120), size=16, alpha=0)
    grate[:, ::4, 3] = 255  # opaque bars every 4th texel column
    grate[::4, :, 3] = 255
    b = _SoupBuilder()
    X, Y, Z = 200.0, 100.0, 100.0
    for p, du, dv in (((0, 0, 0), (X, 0, 0), (0, Y, 0)), ((0, 0, Z), (0, Y, 0), (X, 0, 0)),
                      ((0, 0, 0), (0, Y, 0), (0, 0, Z)), ((X, 0, 0), (0, 0, Z), (0, Y, 0)),
                      ((0, 0, 0), (0, 0, Z), (X, 0, 0)), ((0, Y, 0), (X, 0, 0), (0, 0, Z))):
        b.quad(p, du, dv, texnum=1)
    for x in (60.0, 130.0):  # two-sided grates across the room
        b.quad((x, 0, 0), (0, Y, 0), (0, 0, Z), uv_scale=(6, 6), texnum=2)
        b.quad((x, 0, 0), (0, 0, Z), (0, Y, 0), uv_scale=(6, 6), texnum=2)
    b.quad((95, 40, 0), (0, 0, Z), (0, 20, 0), texnum=1)  # a pillar wall
    b.quad((95, 40, 0), (0, 20, 0), (0, 0, Z), texnum=1)
    atlas = pack_textures([_const_tex((255, 255, 255), 1), _const_tex((200, 200, 200)), grate])
    return b.build(), atlas


def phase5(dev, rng, acc_soup, bundle, accel, config, smi):
    """K2 against its plain version; returns its times and error."""
    from merian_quake_tpu_torch.accel import build_accel, woop
    from merian_quake_tpu_torch.accel.intersect import trace_visibility
    from merian_quake_tpu_torch.models.types import build_scene_from_soup

    full = lambda v, k: torch.full((k,), v, device=dev)
    errs = []

    def compare(name, rays, table, bounds, occ_in=None):
        plain = woop.intersect_woop_any_reference(rays, table, occ_in)
        errs.append(check_k2(name, woop.woop_any(rays, table, *bounds, occ_in), plain))
        return plain

    # random soup: half the rays aimed away, per-ray t_max in [1, 200]
    n = 512
    o = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[: n // 2] = 500.0
    d[: n // 2] = np.abs(d[: n // 2])
    t_max = rng.uniform(1.0, 200.0, n).astype(np.float32)
    t = lambda x: torch.from_numpy(x).to(dev)
    rays, _, (w, lo, hi) = woop.k2_inputs(acc_soup, t(o), t(d), full(1e-3, n), t(t_max))
    compare("random soup", rays, w, (lo, hi))

    # a sky wall (passes light) in front of an opaque wall, both two-sided
    quads, flags = [], []
    for x, flag in ((10.0, 1), (20.0, 0)):
        a, b_, c, e = ([x, -5, -5], [x, 5, -5], [x, 5, 5], [x, -5, 5])
        quads += [(a, e, b_), (c, b_, e), (a, b_, e), (c, e, b_)]
        flags += [flag * 5] * 4  # MAT_FLAGS_SKY = 5
    tri = np.asarray(quads, np.float32)
    sky = build_accel(build_scene_from_soup(tri[:, 0], tri[:, 1], tri[:, 2],
                                            flags=np.asarray(flags, np.int32), device=dev))
    k = 256
    so = np.zeros((k, 3), np.float32)
    so[:, 1:] = rng.uniform(-8, 8, (k, 2))
    sd = np.tile(np.asarray([[1.0, 0.0, 0.0]], np.float32), (k, 1))
    rays, _, (w, lo, hi) = woop.k2_inputs(sky, t(so), t(sd), full(1e-3, k),
                                          t(rng.uniform(5.0, 30.0, k).astype(np.float32)))
    if w is sky.woop_w:
        raise AssertionError("the sky soup's shadow table zeroes nothing")
    compare("sky wall soup", rays, w, (lo, hi))

    # city's 1080p shade-pass shadow rays: subset, then the whole population
    so, sd, st = shade_rays(bundle, accel, config, dev)
    n_full = so.shape[0]
    mid = slice(n_full // 2, n_full // 2 + SUBSET)
    rays, proxy, shadow = woop.k2_inputs(accel, so[mid].contiguous(), sd[mid].contiguous(),
                                         full(1e-3, SUBSET), st[mid].contiguous())
    pre = compare(f"city shade {SUBSET} proxy", rays, proxy[0], proxy[1:])
    compare(f"city shade {SUBSET} shadow", rays, shadow[0], shadow[1:])
    compare(f"city shade {SUBSET} shadow after proxy", rays, shadow[0], shadow[1:], pre)
    rays, proxy, shadow = woop.k2_inputs(accel, so, sd, full(1e-3, n_full), st)
    pre = compare(f"city shade {n_full} proxy", rays, proxy[0], proxy[1:])
    plain = compare(f"city shade {n_full} shadow", rays, shadow[0], shadow[1:])
    warm = woop.woop_any(rays, *shadow, woop.woop_any(rays, *proxy))
    errs.append(check_k2(f"city shade {n_full} shadow after proxy", warm, plain))
    if not (bool(plain.any()) and bool((~plain[:n_full]).any())):
        raise AssertionError("city shade rays: all occluded or none")

    # one visibility trace's K2 work (proxy pre-pass + shadow sweep)
    # against the plain version's, timed in turns
    kern = lambda: woop.woop_any(rays, *shadow, woop.woop_any(rays, *proxy))
    ref = lambda: woop.intersect_woop_any_reference(
        rays, shadow[0], woop.intersect_woop_any_reference(rays, proxy[0]))
    shadow_only = lambda: woop.woop_any(rays, *shadow)
    r1 = cuda_time(ref, 1)
    k_1 = cuda_time(kern, 10)
    s_1 = cuda_time(shadow_only, 10)
    s_2 = cuda_time(shadow_only, 10)
    k_2 = cuda_time(kern, 10)
    r2 = cuda_time(ref, 1)
    log(f"phase 5 timing shade {n_full} rays [{smi}]: K2 proxy + shadow {k_1:.3f} / {k_2:.3f} ms, "
        f"K2 shadow alone {s_1:.3f} / {s_2:.3f} ms, plain {r1:.1f} / {r2:.1f} ms; "
        f"occluded {float(plain[:n_full].float().mean()):.4f}, "
        f"by the proxy {float(pre[:n_full].float().mean()):.4f}")

    # trace_visibility: the card (K2 + alpha table through K1) against the
    # CPU oracle, on an alpha-grate soup
    scene, atlas = grate_soup("cpu")
    acc_cpu = build_accel(scene, atlas)
    if acc_cpu.woop_w_alpha is None:
        raise AssertionError("the grate soup has no alpha-only table")
    acc_gpu = build_accel(scene, atlas, device=dev)
    m = 4096
    a = rng.uniform([2, 2, 2], [198, 98, 98], (m, 3)).astype(np.float32)
    bb = rng.uniform([2, 2, 2], [198, 98, 98], (m, 3)).astype(np.float32)
    cpu = trace_visibility(acc_cpu, atlas, torch.from_numpy(a), torch.from_numpy(bb))
    k1_before, k2_before = woop.woop_nearest.launches, woop.woop_any.launches
    gpu = trace_visibility(acc_gpu, atlas.to(dev), t(a), t(bb)).cpu()
    if woop.woop_any.launches == k2_before or woop.woop_nearest.launches == k1_before:
        raise AssertionError("trace_visibility on the card did not launch K2 and K1")
    agree = float((cpu == gpu).float().mean())
    log(f"phase 5 trace_visibility grate soup {m} segments: visible cpu {float(cpu.float().mean()):.4f} "
        f"card {float(gpu.float().mean()):.4f}, agree {agree:.5f}")
    if agree < VIS_AGREE or bool(cpu.all()) or not bool(cpu.any()):
        raise AssertionError("trace_visibility: the card and the CPU oracle disagree")
    return {"ms": (k_1 + k_2) / 2, "plain_ms": (r1 + r2) / 2, "max_abs_err": max(errs)}


def phase6(dev, bundle, accel, feats, smi):
    """6 ReSTIR frames at 1080p; returns the launches of each kernel."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    config = RenderConfig(width=W, height=H, integrator="restir", features=feats)
    rcfg = ReSTIRConfig()
    state = init_state(config, rcfg, device=dev)
    woop.woop_nearest.launches = 0
    woop.woop_any.launches = 0
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
        if got != (2, 2):
            raise AssertionError(f"ReSTIR frame {i}: (K1, K2) launched {got} times, expected (2, 2)")
    launches = {"woop_nearest": woop.woop_nearest.launches, "woop_any": woop.woop_any.launches}
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
    log(f"phase 6 restir city {W}x{H} [{smi}]: K1 launches {launches['woop_nearest']}, "
        f"K2 launches {launches['woop_any']}; cold {frame_ms[0]:.1f} ms, steady {steady:.1f} "
        f"ms/frame (frames {', '.join(f'{x:.1f}' for x in frame_ms)}); max M {m_max}; "
        f"valid reservoirs {float((res.y_flags & 1).float().mean()):.4f}; "
        f"ldr mean {float(out['ldr'].mean()):.4f}")
    return launches


def phase7(dev):
    """ReSTIR at 64×36, 3 frames: the CPU oracle against the card."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    small = RenderConfig(width=64, height=36, integrator="restir")
    for name, rcfg in (("defaults", ReSTIRConfig()),
                       ("bias 2", ReSTIRConfig(temporal_bias_correction=2, spatial_bias_correction=2))):
        _, out_cpu = render_sequence(city(), small, frames=3, mcpg_config=rcfg, device="cpu")
        k2_before = woop.woop_any.launches
        _, out_gpu = render_sequence(city(), small, frames=3, mcpg_config=rcfg, device=dev)
        k2 = woop.woop_any.launches - k2_before
        expect = 3 * 2 * (3 if rcfg.temporal_bias_correction == 2 else 1)
        if k2 != expect:
            raise AssertionError(f"phase 7 {name}: K2 launched {k2} times, expected {expect}")
        diff = (out_cpu["ldr"] - out_gpu["ldr"].cpu()).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        mean = float(diff.mean())
        log(f"phase 7 restir {name} cpu vs cuda 64x36 x3 frames: K2 launches {k2}; pixels within "
            f"{PIX_TOL} {share:.5f}, mean |d| {mean:.3e}, max |d| {float(diff.max()):.3e}")
        if share < PIX_SHARE or mean >= MEAN_TOL:
            raise AssertionError(f"ReSTIR {name}: CPU and card LDR images disagree")


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
    kernels.build_libraries("woop_nearest", "woop_any")
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name in ("woop_nearest", "woop_any"):
        kernels.load_library(name)
        with open(kernels.library_path(name) + ".log") as f:
            ptxas[name] = " | ".join(line.strip() for line in f if "ptxas info" in line)
    log(f"phase 1 device: {kind} x{count} [{smi}] torch {torch.__version__} "
        f"cuda {torch.version.cuda}; K1 + K2 build {build_s:.2f} s; "
        f"K1 ({ptxas['woop_nearest']}); K2 ({ptxas['woop_any']})")

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
    woop.woop_any.launches = 0
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
    pt_k2 = woop.woop_any.launches
    if pt_k2 != 0:
        raise AssertionError(f"the path-traced frames launched K2 {pt_k2} times, expected 0")
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
    log(f"phase 3 slice city {W}x{H} spp {SPP} mpl {MPL} [{smi}]: K1 launches {launches}, "
        f"K2 launches {pt_k2}; "
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

    # ---- phase 5: K2 vs plain version ----
    k2 = phase5(dev, rng, acc_soup, bundle, accel, config, smi)

    # ---- phase 6: the ReSTIR slice on the card ----
    restir_launches = phase6(dev, bundle, accel, feats, smi)

    # ---- phase 7: CPU oracle vs card K1 + K2, ReSTIR ----
    phase7(dev)

    k_ms = (timings["primary"][0] * 1 + timings["bounce"][0] * 4) / 5
    p_ms = (timings["primary"][1] * 1 + timings["bounce"][1] * 4) / 5
    print(json.dumps({"kernels": [{
        "name": "woop_nearest", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches + restir_launches["woop_nearest"],
        "launches_by_path": {"pt": launches, "restir": restir_launches["woop_nearest"]},
        "max_abs_err": max(max_abs), "ms": k_ms, "plain_ms": p_ms,
    }, {
        "name": "woop_any", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": pt_k2 + restir_launches["woop_any"],
        "launches_by_path": {"pt": pt_k2, "restir": restir_launches["woop_any"]},
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
