"""The trace kernels against their plain versions: K1 (phase 2), K2 (5),
K3 (8), K8 (9), the map's frames (10-11), K4, K5 and the visit list (12),
the list walker (13), the trace schedules' frames (14-15) and the alpha
walk (39)."""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .common import (
    H, MEAN_TOL, MPL, OPS_ANY, OPS_MT, OPS_NEAREST, PIX_SHARE, PIX_TOL, SPP, SUBSET, W,
    bound_ms, check_exact, check_k2, cuda_time, guided_population, launches, log,
    mcpg_scene_config, prepass_ab, reset_launches, timed_call, trace_split, woop_work,
)
from .fixtures import (
    CITY1600, MAP, aimed_rays, bounce_rays, court, edge_boxes, edge_rays, grate_soup,
    primary_rays, shade_rays, sparse_warps, tie_table,
)


# FP32 operations of a (ray, box) slab (K4, K5): the JAX slab's 6 subtracts,
# 6 multiplies and 12 min/max; with each axis's planes ordered and chosen
# once a ray (csrc/woop_keys.cu), 6 min/max
OPS_SLAB, OPS_SLAB_CHOSEN = 24, 18
# K8 against the oracle (t, u, v) and against K3 (t): relative tolerance
T_RTOL = 1e-5
# trace_visibility on the card (Woop) vs the CPU oracle (Möller–Trumbore):
# the two tests round differently on edges and at t_max, so a grazing
# segment may split; at most 2 in 1,000
VIS_AGREE = 0.998


def compare_k1(name, args, woop):
    """Run K1 and its plain version on the same inputs: bit for bit."""
    return check_exact(2, name, woop.woop_nearest(*args),
                       woop.intersect_woop_reference(args[0], args[1]))


def phase2(dev, smi, soup, city_scene):
    """K1 against its plain version, bit for bit: the random soup, also with
    sparse warps, the tie table, 65,536-ray subsets of city's populations,
    then the whole 1080p populations with K1 timed beside the plain
    version's one run, K3 forced on them in turns, and K1's split."""
    from merian_quake_tpu_torch.accel import woop

    acc_soup, o_t, d_t = soup
    n = o_t.shape[0]
    full = lambda v, k: torch.full((k,), v, device=dev)
    max_abs = [compare_k1(
        "random soup", woop.k1_inputs(acc_soup, o_t, d_t, full(0.0, n), full(1e4, n)), woop
    )]
    # the compacted visit, hard: one or two live rays a warp; exact ties
    max_abs.append(compare_k1("random soup sparse warps", woop.k1_inputs(
        acc_soup, o_t, d_t, full(0.0, n), sparse_warps(full(1e4, n))), woop))
    ties = tie_table(dev)
    max_abs.append(compare_k1("tie table sparse warps", ties, woop))
    tie_hits = woop.woop_nearest(*ties)[1]
    if not bool(((tie_hits >= 0) & (tie_hits < 128)).any()):
        raise AssertionError("the tie table: no nearest hit lies on a duplicated triangle")

    bundle, accel, config = city_scene
    n_full = W * H
    po, pd = primary_rays(bundle, accel, dev)
    ubo, ubd, ubt = bounce_rays(bundle, accel, config, dev)  # as a frame traces them
    perm = woop.sort_perm(accel, ubo, ubd, ubt)
    bo, bd, bt = ubo[perm].contiguous(), ubd[perm].contiguous(), ubt[perm].contiguous()
    mid = slice(n_full // 2, n_full // 2 + SUBSET)
    max_abs.append(compare_k1("city primary 65536", woop.k1_inputs(
        accel, po[mid].contiguous(), pd[mid].contiguous(), full(0.0, SUBSET), full(1e4, SUBSET)
    ), woop))
    for t_min in (0.0, 1e-3):
        max_abs.append(compare_k1(f"city bounce 65536 t_min={t_min}", woop.k1_inputs(
            accel, bo[mid].contiguous(), bd[mid].contiguous(), full(t_min, SUBSET),
            bt[mid].contiguous(),
        ), woop))
    max_abs.append(compare_k1("city bounce unsorted 65536 t_min=0.0", woop.k1_inputs(
        accel, ubo[mid].contiguous(), ubd[mid].contiguous(), full(0.0, SUBSET),
        ubt[mid].contiguous(),
    ), woop))

    # full 1080p populations: K1 timed twice, the plain version once, and
    # their outputs held against each other
    timings, k1_split = {}, {}
    for name, args in (
        ("primary", woop.k1_inputs(accel, po, pd, full(0.0, n_full), full(1e4, n_full))),
        ("bounce", woop.k1_inputs(accel, bo, bd, full(0.0, n_full), bt)),
        ("bounce_unsorted", woop.k1_inputs(accel, ubo, ubd, full(0.0, n_full), ubt)),
    ):
        # the plain version's one run (6 s on a whole population) is both
        # the comparison and its time
        ref, r1 = timed_call(lambda: woop.intersect_woop_reference(args[0], args[1]))
        k1 = lambda: woop.woop_nearest(*args)
        max_abs.append(check_exact(2, f"city {name} {n_full} t_min=0.0", k1(), ref[0]))
        k_1 = cuda_time(k1, 10)
        k_2 = cuda_time(k1, 10)
        ops, nbytes = woop_work(woop.woop_nearest, args)
        timings[name] = ((k_1 + k_2) / 2, r1, *bound_ms(ops, nbytes))
        # K3 on the same table: the other side of the routing threshold,
        # timed in turns with K1
        k3 = lambda: woop.woop_stream(*args)
        check_exact(2, f"city {name} {n_full} K3 vs K1", k3(), k1())
        s_1, c_1, c_2, s_2 = cuda_time(k3, 10), cuda_time(k1, 10), cuda_time(k1, 10), cuda_time(k3, 10)
        log(f"phase 2 timing {name} {n_full} rays [{smi}]: K1 {k_1:.3f} / {k_2:.3f} ms, "
            f"plain {r1:.1f} ms; bound {timings[name][2]:.4f} ms "
            f"({timings[name][3]}; {ops / OPS_NEAREST:.4g} pairs tested); K3 forced "
            f"{s_1:.3f} / {s_2:.3f} ms against K1 {c_1:.3f} / {c_2:.3f} ms")
        k1_split[name] = trace_split(2, f"city {name} K1", woop.woop_nearest, args, smi)
    k1_ctas = woop.ctas_per_sm("woop_nearest", accel.cluster_lo.shape[0])
    log(f"phase 2 K1 on city ({accel.cluster_lo.shape[0]} clusters): {k1_ctas} CTAs of 128 "
        f"threads an SM")
    max_abs.append(compare_k1(f"city bounce {n_full} t_min=0.001", woop.k1_inputs(
        accel, bo, bd, full(1e-3, n_full), bt), woop))
    return {"max_abs": max_abs, "timings": timings, "split": k1_split, "ctas_per_sm": k1_ctas}


def phase5(dev, smi, soup_draws, city_scene):
    """K2 against its plain version; returns its times and error."""
    from merian_quake_tpu_torch.accel import build_accel, woop
    from merian_quake_tpu_torch.accel.intersect import trace_visibility
    from merian_quake_tpu_torch.models.types import build_scene_from_soup

    rng, (acc_soup, _, _) = soup_draws
    bundle, accel, config = city_scene
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

    # the shadow sweep as the frames launch it (no pre-pass) against the
    # plain version, in turns; the bound from K2's own count of the pairs
    ops_s, bytes_s = woop_work(woop.woop_any, (rays, *shadow), True)
    ops_p, bytes_p = woop_work(woop.woop_any, (rays, *proxy), True)
    ops_w, bytes_w = woop_work(woop.woop_any, (rays, *shadow), True, occluded_in=pre)
    bound, by = bound_ms(ops_s, bytes_s)
    kern = lambda: woop.woop_any(rays, *shadow)
    ref = lambda: woop.intersect_woop_any_reference(rays, shadow[0])
    k_1, r1 = cuda_time(kern, 10), cuda_time(ref, 1)
    r2, k_2 = cuda_time(ref, 1), cuda_time(kern, 10)
    # F4: one visibility trace without and with the proxy pre-pass (K2 on
    # the proxy table, then K2 on the shadow table warm-started by it)
    with_pre = lambda: woop.woop_any(rays, *shadow, woop.woop_any(rays, *proxy))
    a1, b1, b2, a2 = (cuda_time(kern, 10), cuda_time(with_pre, 10), cuda_time(with_pre, 10),
                      cuda_time(kern, 10))
    errs.append(check_k2(f"city shade {n_full} F4 without vs with the pre-pass", kern(),
                         with_pre()))
    prepass_bound = bound_ms(ops_p, bytes_p)[0] + bound_ms(ops_w, bytes_w)[0]
    log(f"phase 5 timing shade {n_full} rays [{smi}]: K2 shadow {k_1:.3f} / {k_2:.3f} ms, plain "
        f"{r1:.1f} / {r2:.1f} ms; bound {bound:.4f} ms ({by}; {ops_s / OPS_ANY:.4g} pairs tested); "
        f"occluded {float(plain[:n_full].float().mean()):.4f}, by the proxy "
        f"{float(pre[:n_full].float().mean()):.4f}; F4: without the pre-pass {a1:.3f} / {a2:.3f} "
        f"ms, with it (K2 proxy + K2 shadow warm-started) {b1:.3f} / {b2:.3f} ms, bound with it "
        f"{prepass_bound:.4f} ms ({(ops_p + ops_w) / OPS_ANY:.4g} pairs)")
    split = {name: trace_split(5, f"city shade {n_full} K2 {name}", woop.woop_any, args, smi, **kw)
             for name, args, kw in (("shadow", (rays, *shadow), {}), ("proxy", (rays, *proxy), {}),
                                    ("shadow after proxy", (rays, *shadow), {"occluded_in": pre}))}
    ctas = woop.ctas_per_sm("woop_any", shadow[1].shape[0])
    pk = lambda: woop.woop_any(rays, *proxy)
    p1, p2 = cuda_time(pk, 10), cuda_time(pk, 10)
    log(f"phase 5 K2 on city's shadow table ({shadow[1].shape[0]} clusters): {ctas} CTAs of 128 "
        f"threads an SM; on the proxy table {p1:.3f} / {p2:.3f} ms, bound "
        f"{bound_ms(ops_p, bytes_p)[0]:.4f} ms")

    # trace_visibility: the card (K2 + alpha table through the alpha walk)
    # against the CPU oracle, on an alpha-grate soup
    scene, atlas = grate_soup("cpu")
    acc_cpu = build_accel(scene, atlas)
    if acc_cpu.woop_w_alpha is None:
        raise AssertionError("the grate soup has no alpha-only table")
    acc_gpu = build_accel(scene, atlas, device=dev)
    m = 4096
    a = rng.uniform([2, 2, 2], [198, 98, 98], (m, 3)).astype(np.float32)
    bb = rng.uniform([2, 2, 2], [198, 98, 98], (m, 3)).astype(np.float32)
    cpu = trace_visibility(acc_cpu, atlas, torch.from_numpy(a), torch.from_numpy(bb))
    aw_before, k2_before = woop.woop_nearest_alpha.launches, woop.woop_any.launches
    gpu = trace_visibility(acc_gpu, atlas.to(dev), t(a), t(bb)).cpu()
    if (woop.woop_any.launches - k2_before, woop.woop_nearest_alpha.launches - aw_before) != (1, 1):
        raise AssertionError("trace_visibility on the card did not launch K2 and the alpha walk "
                             "once each")
    agree = float((cpu == gpu).float().mean())
    log(f"phase 5 trace_visibility grate soup {m} segments: visible cpu {float(cpu.float().mean()):.4f} "
        f"card {float(gpu.float().mean()):.4f}, agree {agree:.5f}")
    if agree < VIS_AGREE or bool(cpu.all()) or not bool(cpu.any()):
        raise AssertionError("trace_visibility: the card and the CPU oracle disagree")
    return {"ms": (k_1 + k_2) / 2, "plain_ms": (r1 + r2) / 2, "max_abs_err": max(errs),
            "bound_ms": bound, "bound_by": by, "pairs": ops_s / OPS_ANY,
            "f4_city": {"without_ms": (a1 + a2) / 2, "with_ms": (b1 + b2) / 2},
            "lane_use": {k: v["lane_use"] for k, v in split.items()},
            "cycle_shares": {k: v["shares"] for k, v in split.items()}, "ctas_per_sm": ctas}


def phase8(dev, smi, soup, map_scene, map_primary):
    """K3 against its plain versions (subsets) and against K1/K2 on the
    same table (whole populations); K2's map proxy pre-pass against its
    plain version; times and bounds."""
    from merian_quake_tpu_torch.accel import woop

    bundle, accel, config = map_scene
    full = lambda v, k: torch.full((k,), v, device=dev)
    errs = []
    acc_soup, o_t, d_t = soup
    n = o_t.shape[0]
    args = woop.k1_inputs(acc_soup, o_t, d_t, full(0.0, n), full(1e4, n))
    errs.append(check_exact(8, "random soup K3 vs plain", woop.woop_stream(*args),
                            woop.intersect_woop_reference(args[0], args[1])))
    rays, _, shadow = woop.k2_inputs(acc_soup, o_t, d_t, full(1e-3, n), full(60.0, n))
    errs.append(check_k2("random soup K3 any-hit vs plain",
                         woop.woop_stream(rays, *shadow, anyhit=True),
                         woop.intersect_woop_any_reference(rays, shadow[0]), phase=8))
    # the compacted visit, hard: one or two live rays a warp; exact ties
    for name, args in (
        ("random soup sparse warps", woop.k1_inputs(acc_soup, o_t, d_t, full(0.0, n),
                                                    sparse_warps(full(1e4, n)))),
        ("tie table sparse warps", tie_table(dev)),
    ):
        errs.append(check_exact(8, f"{name} K3 vs plain", woop.woop_stream(*args),
                                woop.intersect_woop_reference(args[0], args[1])))
        errs.append(check_k2(f"{name} K3 any-hit vs plain", woop.woop_stream(*args, anyhit=True),
                             woop.intersect_woop_any_reference(args[0], args[1]), phase=8))

    n_full = W * H
    po, pd = map_primary
    ubo, ubd, ubt = bounce_rays(bundle, accel, config, dev)  # as a frame traces them
    perm = woop.sort_perm(accel, ubo, ubd, ubt)
    bo, bd, bt = ubo[perm].contiguous(), ubd[perm].contiguous(), ubt[perm].contiguous()
    so, sd, st = shade_rays(bundle, accel, config, dev)
    mid = slice(n_full // 2, n_full // 2 + SUBSET)
    sub = lambda x: x[mid].contiguous()
    subsets = {
        "primary": woop.k1_inputs(accel, sub(po), sub(pd), full(0.0, SUBSET), full(1e4, SUBSET)),
        "bounce": woop.k1_inputs(accel, sub(bo), sub(bd), full(0.0, SUBSET), sub(bt)),
        "bounce_unsorted": woop.k1_inputs(accel, sub(ubo), sub(ubd), full(0.0, SUBSET), sub(ubt)),
    }
    for name, args in subsets.items():
        errs.append(check_exact(8, f"map {name} {SUBSET} t_min=0.0 K3 vs plain",
                                woop.woop_stream(*args),
                                woop.intersect_woop_reference(args[0], args[1])))
    args = woop.k1_inputs(accel, sub(bo), sub(bd), full(1e-3, SUBSET), sub(bt))
    errs.append(check_exact(8, f"map bounce {SUBSET} t_min=0.001 K3 vs plain",
                            woop.woop_stream(*args), woop.intersect_woop_reference(args[0], args[1])))
    rays, proxy, shadow = woop.k2_inputs(accel, sub(so), sub(sd), full(1e-3, SUBSET), sub(st))
    pre = woop.woop_any(rays, *proxy)
    errs.append(check_k2(f"map shade {SUBSET} K2 proxy vs plain", pre,
                         woop.intersect_woop_any_reference(rays, proxy[0]), phase=8))
    plain = woop.intersect_woop_any_reference(rays, shadow[0])
    errs.append(check_k2(f"map shade {SUBSET} K3 any-hit vs plain",
                         woop.woop_stream(rays, *shadow, anyhit=True), plain, phase=8))
    errs.append(check_k2(f"map shade {SUBSET} K3 any-hit after proxy vs plain",
                         woop.woop_stream(rays, *shadow, anyhit=True, occluded_in=pre), plain,
                         phase=8))
    subsets["shadow"] = (rays, shadow, pre)
    # any-hit on the whole table (no shadow table): the map's primary rays
    args = woop.k1_inputs(accel, sub(po), sub(pd), full(1e-3, SUBSET), full(1e4, SUBSET))
    errs.append(check_k2(f"map primary {SUBSET} t_min=0.001 K3 any-hit vs plain",
                         woop.woop_stream(*args, anyhit=True),
                         woop.intersect_woop_any_reference(args[0], args[1]), phase=8))

    # the whole populations: K3 against K1/K2 on the same table
    pops = {
        "primary": woop.k1_inputs(accel, po, pd, full(0.0, n_full), full(1e4, n_full)),
        "bounce": woop.k1_inputs(accel, bo, bd, full(0.0, n_full), bt),
        "bounce_unsorted": woop.k1_inputs(accel, ubo, ubd, full(0.0, n_full), ubt),
    }
    for name, args in pops.items():
        errs.append(check_exact(8, f"map {name} {n_full} t_min=0.0 K3 vs K1",
                                woop.woop_stream(*args), woop.woop_nearest(*args)))
    args = woop.k1_inputs(accel, bo, bd, full(1e-3, n_full), bt)
    errs.append(check_exact(8, f"map bounce {n_full} t_min=0.001 K3 vs K1",
                            woop.woop_stream(*args), woop.woop_nearest(*args)))
    rays_f, proxy_f, shadow_f = woop.k2_inputs(accel, so, sd, full(1e-3, n_full), st)
    pre_f = woop.woop_any(rays_f, *proxy_f)
    errs.append(check_k2(f"map shade {n_full} K2 proxy vs plain", pre_f,
                         woop.intersect_woop_any_reference(rays_f, proxy_f[0]), phase=8))
    occ = woop.woop_any(rays_f, *shadow_f)
    errs.append(check_k2(f"map shade {n_full} K3 any-hit vs K2",
                         woop.woop_stream(rays_f, *shadow_f, anyhit=True), occ, phase=8))
    errs.append(check_k2(f"map shade {n_full} K3 any-hit after proxy vs K2 after proxy",
                         woop.woop_stream(rays_f, *shadow_f, anyhit=True, occluded_in=pre_f),
                         woop.woop_any(rays_f, *shadow_f, pre_f), phase=8))
    if not (bool(occ.any()) and bool((~occ[:n_full]).any())):
        raise AssertionError("map shade rays: all occluded or none")
    log(f"phase 8 map shade {n_full}: occluded {float(occ[:n_full].float().mean()):.4f}, "
        f"by the proxy {float(pre_f[:n_full].float().mean()):.4f}")
    # F4 on the map: one visibility trace without the proxy pre-pass (K3
    # any-hit) and with it (K2 on the proxy table, then K3 warm-started)
    without = lambda: woop.woop_stream(rays_f, *shadow_f, anyhit=True)
    with_pre = lambda: woop.woop_stream(rays_f, *shadow_f, anyhit=True,
                                        occluded_in=woop.woop_any(rays_f, *proxy_f))
    errs.append(check_k2(f"map shade {n_full} F4 without vs with the pre-pass", without(),
                         with_pre(), phase=8))
    k2_pre = lambda: woop.woop_any(rays_f, *proxy_f)
    a1, b1, b2, a2 = (cuda_time(without, 5), cuda_time(with_pre, 5), cuda_time(with_pre, 5),
                      cuda_time(without, 5))
    p1, p2 = cuda_time(k2_pre, 5), cuda_time(k2_pre, 5)
    ops_p, bytes_p = woop_work(woop.woop_any, (rays_f, *proxy_f), True)
    f4_map = {"without_ms": (a1 + a2) / 2, "with_ms": (b1 + b2) / 2, "k2_proxy_ms": (p1 + p2) / 2,
              "k2_proxy_bound_ms": bound_ms(ops_p, bytes_p)[0]}
    log(f"phase 8 F4 map shade {n_full} rays [{smi}]: without the proxy pre-pass (K3 any-hit) "
        f"{a1:.3f} / {a2:.3f} ms, with it (K2 proxy + K3 warm-started) {b1:.3f} / {b2:.3f} ms; "
        f"K2 on the proxy table ({proxy_f[1].shape[0]} clusters) {p1:.3f} / {p2:.3f} ms, bound "
        f"{f4_map['k2_proxy_bound_ms']:.4f} ms ({ops_p / OPS_ANY:.4g} pairs tested)")

    # times: K3 and K1/K2 on the whole populations in turns (K3, K1, K1,
    # K3; 5 launches a reading), then K3 and the plain version on the
    # subsets (plain, K3, K3, plain); bounds from K3's counts
    kern = {
        "primary": (lambda: woop.woop_stream(*pops["primary"]),
                    lambda: woop.woop_nearest(*pops["primary"])),
        "bounce": (lambda: woop.woop_stream(*pops["bounce"]),
                   lambda: woop.woop_nearest(*pops["bounce"])),
        "bounce_unsorted": (lambda: woop.woop_stream(*pops["bounce_unsorted"]),
                            lambda: woop.woop_nearest(*pops["bounce_unsorted"])),
        "shadow": (lambda: woop.woop_stream(rays_f, *shadow_f, anyhit=True, occluded_in=pre_f),
                   lambda: woop.woop_any(rays_f, *shadow_f, pre_f)),
    }
    rays_s, shadow_s, pre_s = subsets["shadow"]
    plain = {
        "primary": (lambda: woop.intersect_woop_reference(*subsets["primary"][:2]),
                    lambda: woop.woop_stream(*subsets["primary"])),
        "bounce": (lambda: woop.intersect_woop_reference(*subsets["bounce"][:2]),
                   lambda: woop.woop_stream(*subsets["bounce"])),
        "bounce_unsorted": (lambda: woop.intersect_woop_reference(*subsets["bounce_unsorted"][:2]),
                            lambda: woop.woop_stream(*subsets["bounce_unsorted"])),
        "shadow": (lambda: woop.intersect_woop_any_reference(rays_s, shadow_s[0], pre_s),
                   lambda: woop.woop_stream(rays_s, *shadow_s, anyhit=True, occluded_in=pre_s)),
    }
    out = {}
    for name in ("primary", "bounce", "bounce_unsorted", "shadow"):
        k3, other = kern[name]
        a1, b1, b2, a2 = cuda_time(k3, 5), cuda_time(other, 5), cuda_time(other, 5), cuda_time(k3, 5)
        ref, k3s = plain[name]
        p1, s1, s2, p2 = cuda_time(ref, 1), cuda_time(k3s, 5), cuda_time(k3s, 5), cuda_time(ref, 1)
        if name == "shadow":
            ops, nbytes = woop_work(woop.woop_stream, (rays_f, *shadow_f), True, anyhit=True,
                                    occluded_in=pre_f)
        else:
            ops, nbytes = woop_work(woop.woop_stream, pops[name])
        bnd, by = bound_ms(ops, nbytes)
        if name == "shadow":
            split = trace_split(8, "map shadow K3 any-hit after proxy", woop.woop_stream,
                                (rays_f, *shadow_f), smi, anyhit=True, occluded_in=pre_f)
        else:
            split = trace_split(8, f"map {name} K3", woop.woop_stream, pops[name], smi)
        out[name] = {"ms": (a1 + a2) / 2, "other_ms": (b1 + b2) / 2, "plain_ms": (p1 + p2) / 2,
                     "subset_ms": (s1 + s2) / 2, "bound_ms": bnd, "bound_by": by,
                     "lane_use": split["lane_use"], "shares": split["shares"]}
        log(f"phase 8 timing map {name} [{smi}]: K3 {a1:.3f} / {a2:.3f} ms, "
            f"{'K2' if name == 'shadow' else 'K1'} {b1:.3f} / {b2:.3f} ms on {n_full} rays; "
            f"on {SUBSET} rays plain {p1:.1f} / {p2:.1f} ms, K3 {s1:.3f} / {s2:.3f} ms; "
            f"bound {bnd:.4f} ms ({by}; {ops / (OPS_ANY if name == 'shadow' else OPS_NEAREST):.4g} "
            f"pairs tested)")
    out["max_abs_err"] = max(errs)
    out["f4_map"] = f4_map
    out["ctas_per_sm"] = woop.ctas_per_sm("woop_stream", accel.cluster_lo.shape[0])
    log(f"phase 8 K3 on the map ({accel.cluster_lo.shape[0]} clusters): {out['ctas_per_sm']} CTAs "
        f"of 128 threads an SM")
    return out


def check_k8(name, kernel_out, oracle_out):
    """K8's (t, tri, u, v) against the oracle's: bit for bit on every ray.
    Returns the largest |t difference| (0)."""
    torch.cuda.synchronize()
    bits = [int((a.view(torch.int32) != b.view(torch.int32)).sum())
            for a, b in zip(kernel_out, oracle_out)]
    log(f"phase 9 {name}: rays={kernel_out[0].numel()} hits={int((oracle_out[1] >= 0).sum())} "
        f"t, tri, u, v not bit-equal on {bits[0]}, {bits[1]}, {bits[2]}, {bits[3]} rays")
    if any(bits):
        raise AssertionError(f"{name}: K8 and the oracle differ")
    return float((kernel_out[0] - oracle_out[0]).abs().max())


def phase9(dev, smi, soup, map_scene, map_primary):
    """K8 against the oracle on CUDA tensors, bit for bit, and against K3;
    the dense path's launches, times in turns with K3, and the bounds."""
    from merian_quake_tpu_torch.accel import dense, woop
    from merian_quake_tpu_torch.accel.intersect import _intersect_oracle

    accel, (po, pd) = map_scene[1], map_primary
    acc_soup, o_t, d_t = soup
    errs = [check_k8("random soup K8 vs oracle", dense.intersect_dense(acc_soup, o_t, d_t, 0.0, 1e4),
                     _intersect_oracle(acc_soup, o_t, d_t, 0.0, 1e4))]
    n_full = W * H
    mid = slice(n_full // 2, n_full // 2 + SUBSET)
    o, d = po[mid].contiguous(), pd[mid].contiguous()
    table = dense.scene_table(accel)  # once a scene, before the path
    reset_launches()
    hr = dense.intersect_dense(accel, o, d, 0.0, 1e4)  # the dense path
    got = launches()
    if got != {**{k: 0 for k in got}, "mt_dense": 1}:
        raise AssertionError(f"intersect_dense launched {got}, expected K8 once")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref = _intersect_oracle(accel, o, d, 0.0, 1e4)
    stop.record()
    torch.cuda.synchronize()
    p1 = start.elapsed_time(stop)
    errs.append(check_k8(f"map primary {SUBSET} K8 vs oracle", hr, ref))
    k3_args = woop.k1_inputs(accel, o, d, torch.zeros_like(o[:, 0]), torch.full_like(o[:, 0], 1e4))
    t3, tri3 = woop.woop_stream(*k3_args)
    t3, tri3 = t3[:SUBSET], tri3[:SUBSET]
    agree = (hr.t - t3).abs() <= T_RTOL * torch.clamp_min(t3.abs(), 1e-6)
    share = float(agree.float().mean())
    ties = int((agree & (hr.tri != tri3)).sum())
    log(f"phase 9 map primary {SUBSET} K8 vs K3: t within {T_RTOL} rel on {share:.6f} of rays "
        f"({int((~agree).sum())} split on an edge); tri differ at an equal t on {ties}")
    if share < 0.9999:
        raise AssertionError("K8 and K3 disagree on the map")
    rays = woop._pack_rays(o, d, torch.zeros_like(o[:, 0]), torch.full_like(o[:, 0], 1e4), 128)
    k8 = lambda: dense.mt_dense(rays, table)
    k3 = lambda: woop.woop_stream(*k3_args)
    k_1, c_1, c_2, k_2 = cuda_time(k8, 3), cuda_time(k3, 3), cuda_time(k3, 3), cuda_time(k8, 3)
    p2 = cuda_time(lambda: dense.intersect_dense_reference(rays, table), 1)
    T = table.shape[0]
    # the bounds: every pair's 46 operations (no cull), and the operations
    # these inputs need under the pre-tests (K8's counts: 14 a pair, 8 a
    # pair past level 1, 19 past level 2, 5 past level 3)
    counts = torch.zeros((SUBSET // 128, 3), dtype=torch.int64, device=dev)
    dense.mt_dense(rays, table, counts=counts)
    n1, n2, n3 = (int(x) for x in counts.sum(0))
    pairs = float(SUBSET) * T
    nbytes = SUBSET * (32 + 16) + T * 48
    every, by_every = bound_ms(pairs * OPS_MT, nbytes)
    need_ops = 14 * pairs + 8 * n1 + 19 * n2 + 5 * n3
    bnd, by = bound_ms(need_ops, nbytes)
    log(f"phase 9 timing map primary {SUBSET} rays x {T} triangles [{smi}]: K8 {k_1:.3f} / "
        f"{k_2:.3f} ms, K3 on the same rays {c_1:.3f} / {c_2:.3f} ms, plain {p1:.1f} / {p2:.1f} "
        f"ms; bound {every:.4f} ms ({by_every}, {OPS_MT} operations every pair), {bnd:.4f} ms "
        f"({by}) from the operations these inputs need ({need_ops / pairs:.3f} a pair: pairs "
        f"past pre-test level 1 {n1 / pairs:.4f}, level 2 {n2 / pairs:.4f}, level 3 "
        f"{n3 / pairs:.4f})")
    return {"ms": (k_1 + k_2) / 2, "plain_ms": (p1 + p2) / 2, "bound_ms": bnd, "bound_by": by,
            "bound_every_pair_ms": every, "k3_ms": (c_1 + c_2) / 2,
            "passed": {"level1": n1, "level2": n2, "level3": n3, "pairs": pairs},
            "max_abs_err": max(errs), "launches": got}


def phase10(dev, smi, map_scene):
    """6 PT and 6 ReSTIR frames of the map at 1080p; returns each path's
    launches."""
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    bundle, accel, config = map_scene
    per_path = {}
    for integrator, expect in (
        ("pt", {"woop_stream": 5}),
        ("restir", {"woop_stream": 3, "woop_stream_any": 1}),
    ):
        cfg = config._replace(integrator=integrator)
        rcfg = ReSTIRConfig() if integrator == "restir" else None
        state = init_state(cfg, rcfg, device=dev)
        reset_launches()
        frame_ms = []
        for i in range(6):
            before = launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=i), cfg,
                                      state, rcfg)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            got = {k: v - before[k] for k, v in launches().items()}
            if got != {**{k: 0 for k in got}, **expect}:
                raise AssertionError(f"map {integrator} frame {i}: launched {got}, expected {expect}")
        per_path[integrator] = launches()
        for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]), ("irradiance", out["irradiance"]),
                        ("accum_irradiance", state.accum_irradiance)):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"map {integrator} {name} is not finite")
        if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
            raise AssertionError(f"map {integrator} ldr has the wrong shape or is constant")
        steady = float(np.mean(frame_ms[2:]))
        rate = ""
        if integrator == "pt":
            rate = f", {W * H * (1 + SPP * (MPL - 1)) / steady / 1e3:.2f} Mrays/s"
        log(f"phase 10 {integrator} map {W}x{H} [{smi}]: launches {per_path[integrator]}; cold "
            f"{frame_ms[0]:.1f} ms, steady {steady:.1f} ms/frame (frames "
            f"{', '.join(f'{x:.1f}' for x in frame_ms)}){rate}; ldr mean {float(out['ldr'].mean()):.4f}")
    f4 = prepass_ab(10, "restir map", bundle, accel, config._replace(integrator="restir"), dev, smi)
    return per_path, f4


def phase11(dev):
    """2 PT and 2 ReSTIR frames of the map at 32×18: CPU oracle against
    the card (K3 + K2)."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    bundle = city(**MAP, device="cpu")
    for name, cfg, rcfg in (
        ("pt", RenderConfig(width=32, height=18, spp=SPP, max_path_length=MPL), None),
        ("restir", RenderConfig(width=32, height=18, integrator="restir"), ReSTIRConfig()),
    ):
        t0 = time.perf_counter()
        _, out_cpu = render_sequence(bundle, cfg, frames=2, mcpg_config=rcfg, device="cpu")
        cpu_s = time.perf_counter() - t0
        k1, k3 = woop.woop_nearest.launches, woop.woop_stream.launches
        # no device=: the entry point's default is the card
        _, out_gpu = render_sequence(bundle, cfg, frames=2, mcpg_config=rcfg)
        if out_gpu["ldr"].device != dev:
            raise AssertionError(f"render_sequence without device= ran on {out_gpu['ldr'].device}")
        if woop.woop_stream.launches == k3 or woop.woop_nearest.launches != k1:
            raise AssertionError(f"map {name} 32x18 on the card did not trace through K3 alone")
        diff = (out_cpu["ldr"] - out_gpu["ldr"].cpu()).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        mean = float(diff.mean())
        log(f"phase 11 map {name} cpu vs cuda 32x18 x2 frames (cpu {cpu_s:.1f} s): pixels within "
            f"{PIX_TOL} {share:.5f}, mean |d| {mean:.3e}, max |d| {float(diff.max()):.3e}")
        if share < PIX_SHARE or mean >= MEAN_TOL:
            raise AssertionError(f"map {name}: CPU and card LDR images disagree")


def _sub(pop):
    n_full = W * H
    mid = slice(n_full // 2, n_full // 2 + SUBSET)
    return tuple(x[mid].contiguous() for x in pop)


def timed_turns(plain, kernel, reps):
    """(kernel ms, plain ms): plain, kernel, kernel, plain; plain once a
    reading, the kernel ``reps`` times."""
    p1, k1, k2, p2 = (cuda_time(plain, 1), cuda_time(kernel, reps), cuda_time(kernel, reps),
                      cuda_time(plain, 1))
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase12(dev, smi, soup, city1600):
    """K4, K5 (both modes) and the fused visit list against their plain
    versions, bit for bit; times in turns, bounds at 24 and 18 operations
    a slab and, for K4, at the slabs its counting instance computed."""
    from merian_quake_tpu_torch.accel import woop

    acc_soup, o_t, d_t = soup
    _, accel, _, pops = city1600

    errs = {"K4": [], "K5": [], "list": []}

    def same_bits(kernel, name, a, b):
        torch.cuda.synchronize()
        bad = a.view(torch.int32) != b.view(torch.int32)
        differ = int(bad.sum())
        # |kernel - plain| where the bits differ (inf where only one is inf)
        gap = torch.where(bad, (a.double() - b.double()).abs().nan_to_num(float("inf")), 0.0)
        errs[kernel].append(float(gap.max()))
        log(f"phase 12 {name}: {a.numel()} values, differ={differ}, max |kernel - plain| "
            f"{errs[kernel][-1]}")
        if differ:
            raise AssertionError(f"{name}: kernel and plain version differ on {differ} values")

    def same_list(name, rays, lo, hi):
        got, ref = woop.visit_list(rays, lo, hi), woop.visit_list_reference(rays, lo, hi)
        same_bits("list", f"{name} visit list te_s", got[0], ref[0])
        same_bits("list", f"{name} visit list order", got[1], ref[1])

    # (name, rays, K4's and the JAX mode's boxes, the walker's boxes)
    n = o_t.shape[0]
    full = lambda v, k: torch.full((k,), v, device=dev)
    inputs = []
    for name, acc, o, d, t_min, t_max in (
            [("random soup", acc_soup, o_t, d_t, full(0.0, n), full(60.0, n))]
            + [(f"city1600 {k} {SUBSET}", accel, *_sub(pops[k]))
               for k in ("primary", "bounce", "bounce_target")]
            + [(f"city1600 bounce_target {W * H}", accel, *pops["bounce_target"])]):
        rays, _, lo, hi = woop.k1_inputs(acc, o, d, t_min, t_max)
        inputs.append((name, rays, acc.cluster_lo, acc.cluster_hi, lo, hi))
    rng = np.random.default_rng(12)
    rays_e = edge_rays(rng, device=dev)
    for m in (3, 100, 1024):
        lo, hi = edge_boxes(rng, m, device=dev)
        inputs.append((f"edge boxes m={m}", rays_e, lo, hi, lo, hi))
    for m in (3, 100, 256):
        lo, hi = edge_boxes(rng, m, few_empty=True, device=dev)
        same_bits("K4", f"edge boxes m={m} (two empty) K4", woop.target_keys(rays_e, lo, hi),
                  woop.target_keys_reference(rays_e, lo, hi))
    for name, rays, clo, chi, wlo, whi in inputs:
        if clo.shape[0] <= woop.MAX_KEY_CLUSTERS:
            ref = woop.target_keys_reference(rays, clo, chi)
            same_bits("K4", f"{name} K4", woop.target_keys(rays, clo, chi), ref)
            counts = torch.zeros((rays.shape[1] // 128, 3), dtype=torch.int64, device=dev)
            same_bits("K4", f"{name} K4 counting instance",
                      woop.target_keys(rays, clo, chi, counts=counts), ref)
        boxes = {"clusters": (clo, chi, wlo, whi),
                 "nodes8": (*woop.node_bounds(clo, chi, 8), *woop.node_bounds(wlo, whi, 8))}
        for bname, (jlo, jhi, blo, bhi) in boxes.items():
            same_bits("K5", f"{name} K5 {bname} JAX mode", woop.te_union(rays, jlo, jhi),
                      woop.te_union_reference(rays, jlo, jhi))
            same_bits("K5", f"{name} K5 {bname} walker mode",
                      woop.te_union(rays, blo, bhi, slack=True),
                      woop.te_union_reference(rays, blo, bhi, slack=True))
            same_list(f"{name} {bname}", rays, blo, bhi)

    # times on the whole populations as the frames launch them: K4 on the
    # bounce rays in pixel order, K5 (walker mode) and the list on the
    # target-sorted ones
    nf = W * H
    rays_b = woop.k1_inputs(accel, *pops["bounce"])[0]
    rays_t, _, lo, hi = woop.k1_inputs(accel, *pops["bounce_target"])
    nc = accel.cluster_lo.shape[0]
    nlo, nhi = woop.node_bounds(lo, hi, 8)
    out = {"max_abs_err": {k: max(v) for k, v in errs.items()}}
    k4 = timed_turns(lambda: woop.target_keys_reference(rays_b, accel.cluster_lo, accel.cluster_hi),
                     lambda: woop.target_keys(rays_b, accel.cluster_lo, accel.cluster_hi), 10)
    counts = torch.zeros((nf // 128, 3), dtype=torch.int64, device=dev)
    woop.target_keys(rays_b, accel.cluster_lo, accel.cluster_hi, counts=counts)
    work = dict(zip(woop.KEY_COUNTS, (int(x) for x in counts.sum(0))))
    k4_bytes = nf * 32 + nf * 4 + nc * 24
    out["K4"] = {"ms": k4[0], "plain_ms": k4[1], "boxes": nc, "counts": work,
                 **slab_bounds(nf * nc, work["slabs"] + work["node_slabs"], k4_bytes)}
    # K5 needs the slabs of the live rays (limit >= 0) with every box
    live = int((woop.list_slack(rays_t[7]) >= 0.0).sum())
    for bname, (blo, bhi) in (("clusters", (lo, hi)), ("nodes8", (nlo, nhi))):
        m = blo.shape[0]
        k5 = timed_turns(lambda: woop.te_union_reference(rays_t, blo, bhi, slack=True),
                         lambda: woop.te_union(rays_t, blo, bhi, slack=True), 10)
        union_bytes = nf * 32 + (nf // 128) * m * 4 + m * 24
        out[f"K5 {bname}"] = {"ms": k5[0], "plain_ms": k5[1], "boxes": m, "live_rays": live,
                              **slab_bounds(nf * m, live * m, union_bytes)}
        # the list: the fused entry against K5 + torch's row sort (the route
        # before the fusion), in turns, and against its plain version
        fused = lambda: woop.visit_list(rays_t, blo, bhi)
        unfused = lambda: torch.sort(woop.te_union(rays_t, blo, bhi, slack=True), dim=1,
                                     stable=True)
        u1, f1, f2, u2 = (cuda_time(unfused, 10), cuda_time(fused, 10), cuda_time(fused, 10),
                          cuda_time(unfused, 10))
        plain = cuda_time(lambda: woop.visit_list_reference(rays_t, blo, bhi), 1)
        out[f"list {bname}"] = {"ms": (f1 + f2) / 2, "plain_ms": plain,
                                "unfused_ms": (u1 + u2) / 2, "boxes": m, "live_rays": live,
                                **slab_bounds(nf * m, live * m,
                                              union_bytes + (nf // 128) * m * 4)}
    for name, r in ((k, v) for k, v in out.items() if k != "max_abs_err"):
        if name == "K4":
            need = (f"the {r['need_slabs'] / (nf * nc):.4f} of rays x boxes its counting "
                    f"instance computed {r['counts']}")
        else:
            need = f"its {r['live_rays']} live rays x boxes"
        extra = f"; K5 + torch.sort {r['unfused_ms']:.3f} ms in turns" if "unfused_ms" in r else ""
        log(f"phase 12 timing {name} ({r['boxes']} boxes) on {nf} bounce rays [{smi}]: kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.1f} ms; bound {r['bound_ms']:.4f} ms at "
            f"{OPS_SLAB_CHOSEN} operations a slab of {need} ({r['bound_by']}, share "
            f"{r['bound_ms'] / r['ms']:.3f}); over every ray x box {r['bound_18_ms']:.4f} ms at "
            f"{OPS_SLAB_CHOSEN} (share {r['bound_18_ms'] / r['ms']:.3f}), {r['bound_24_ms']:.4f} "
            f"ms at the JAX slab's {OPS_SLAB} (share {r['bound_24_ms'] / r['ms']:.3f}){extra}")
    return out


def slab_bounds(slabs, need, nbytes):
    """The bounds of a kernel over ``slabs`` (ray, box) slabs moving
    ``nbytes``: bound_ms (bound_by) at 18 operations a slab (each axis's
    planes ordered and chosen once a ray) over the ``need`` slabs this
    run's data needs; beside it 18 and the JAX slab's 24 a slab over every
    slab (bound_18_ms, bound_24_ms)."""
    bnd, by = bound_ms(OPS_SLAB_CHOSEN * need, nbytes)
    return {"bound_ms": bnd, "bound_by": by, "need_slabs": need,
            "bound_18_ms": bound_ms(OPS_SLAB_CHOSEN * slabs, nbytes)[0],
            "bound_24_ms": bound_ms(OPS_SLAB * slabs, nbytes)[0]}


def guided_1600(dev, c16):
    """The 4,147,200 guided rays of the first MCPG bounce segment on
    city(1600) after 4 frames, sorted by the target key as
    ``TraceSchedule(True, 8, 32)`` sorts them: (o, d, t_min, t_max)."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    bundle, accel, config, _ = c16
    cfg, mcfg = mcpg_scene_config(config)
    state = init_state(cfg, mcfg, device=dev)
    for f in range(4):
        state, _ = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=f), cfg,
                                state, mcfg)
    o, d, t_max = guided_population(bundle, accel, cfg, mcfg, state, 4)[1][0]
    perm = torch.sort(woop.target_sort_key(accel, o, d, t_max), stable=True).indices
    return (o[perm].contiguous(), d[perm].contiguous(), torch.zeros_like(t_max),
            t_max[perm].contiguous())


def phase13(dev, smi, soup, city1600):
    """The walker against its plain versions, bit for bit (nearest) and on
    every ray (any-hit), in every mode (P = 1, 8, 16, 32, 64, 128; compact 0
    and 32), and on the MCPG guided rays under (True, 8, 32); its counts,
    profile and times against the parent-less yardsticks K1/K2."""
    from merian_quake_tpu_torch.accel import woop

    acc_soup, o_t, d_t = soup
    _, accel, _, pops = city1600
    S = woop.TraceSchedule
    modes = [S(), S(compact=32), S(node_clusters=8), S(node_clusters=8, compact=32),
             S(node_clusters=16), S(node_clusters=16, compact=32), S(node_clusters=32),
             S(node_clusters=64, compact=32), S(node_clusters=128)]
    tag = lambda s, nc=252: f"P={woop.schedule_nodes(s, nc)} compact={s.compact}"
    n = o_t.shape[0]
    full = lambda v, k: torch.full((k,), v, device=dev)
    errs = []
    nearest = [("random soup", acc_soup, (o_t, d_t, full(0.0, n), full(60.0, n)))]
    nearest += [(f"city1600 {k} {SUBSET}", accel, _sub(pops[k])) for k in ("primary", "bounce_target")]
    nearest += [(f"city1600 {k} {W * H}", accel, pops[k]) for k in ("primary", "bounce_target")]
    for name, acc, pop in nearest:
        args = woop.k1_inputs(acc, *pop)
        plain = woop.intersect_woop_reference(args[0], args[1])
        for s in modes:
            errs.append(check_exact(13, f"{name} walker {tag(s, acc.cluster_lo.shape[0])}",
                                    woop._walk(*args, s), plain))
    anyhit = [("random soup", acc_soup, (o_t, d_t, full(60.0, n))),
              (f"city1600 shade {SUBSET}", accel, _sub(pops["shade"])),
              (f"city1600 shade {W * H}", accel, pops["shade"])]
    for name, acc, (o, d, t_max) in anyhit:
        rays, proxy, shadow = woop.k2_inputs(acc, o, d, torch.full_like(t_max, 1e-3), t_max)
        plain = woop.intersect_woop_any_reference(rays, shadow[0])
        pre = None if proxy is None else woop.woop_any(rays, *proxy)
        for s in (S(), S(node_clusters=8), S(node_clusters=16), S(node_clusters=32),
                  S(node_clusters=64), S(node_clusters=128)):
            label = f"{name} walker any-hit {tag(s, acc.cluster_lo.shape[0])}"
            errs.append(check_k2(label, woop._walk(rays, *shadow, s, anyhit=True), plain,
                                 phase=13))
            if pre is not None:
                errs.append(check_k2(f"{label} after proxy",
                                     woop._walk(rays, *shadow, s, anyhit=True, occluded_in=pre),
                                     plain, phase=13))
    # the MCPG guided rays under (True, 8, 32): against the plain version on
    # a subset, against K1 on all 4,147,200
    guided = guided_1600(dev, city1600)
    ng = guided[0].shape[0]
    mid = slice(ng // 2, ng // 2 + SUBSET)
    sub = woop.k1_inputs(accel, *(x[mid].contiguous() for x in guided))
    errs.append(check_exact(13, f"city1600 guided {SUBSET} walker (True, 8, 32) vs plain",
                            woop._walk(*sub, S(True, 8, 32)),
                            woop.intersect_woop_reference(sub[0], sub[1])))
    g_args = woop.k1_inputs(accel, *guided)
    errs.append(check_exact(13, f"city1600 guided {ng} walker (True, 8, 32) vs K1",
                            woop._walk(*g_args, S(True, 8, 32)), woop.woop_nearest(*g_args)))

    # counts, profile and times on the whole populations, against K1 / K2
    # on the same rays (the walk with its list: the visit list, the walker)
    out = {"ctas_per_sm": woop.ctas_per_sm("woop_list", accel.cluster_lo.shape[0])}
    for pname, s, anyhit in (("bounce_target", S(), False), ("bounce_target", S(node_clusters=8), False),
                             ("bounce_target", S(node_clusters=8, compact=32), False),
                             ("primary", S(node_clusters=8, compact=32), False),
                             ("shade", S(node_clusters=8), True),
                             ("guided", S(node_clusters=8, compact=32), False)):
        if pname == "shade":
            rays, _, (w, lo, hi) = woop.k2_inputs(accel, *pops["shade"][:2],
                                                  full(1e-3, W * H), pops["shade"][2])
            args = (rays, w, lo, hi)
        else:
            rays, w, lo, hi = args = g_args if pname == "guided" else woop.k1_inputs(
                accel, *pops[pname])
        nr = rays.shape[1]
        P = max(s.node_clusters, 1)
        blo, bhi = woop.node_bounds(lo, hi, P) if P > 1 else (lo, hi)
        lst = woop.visit_list(rays, blo, bhi)
        kw = dict(node_lo=blo, node_hi=bhi, nodes=P, compact=s.compact, anyhit=anyhit)
        if P == 1:
            kw = dict(compact=s.compact)
        counts = torch.zeros((nr // 128, 3), dtype=torch.int64, device=dev)
        woop.woop_list(rays, w, lo, hi, *lst, counts=counts, **kw)
        pairs, visits, cvisits = (int(x) for x in counts.sum(0))
        label = f"{pname} {tag(s)}" + (" any" if anyhit else "")
        if s.compact and not cvisits:
            raise AssertionError(f"{label}: no compacted visit")
        split = trace_split(13, f"city1600 {label} walker",
                            lambda *a, **k: woop.woop_list(*a, *lst, **kw, **k), args, smi)
        ref = woop.woop_any if anyhit else woop.woop_nearest
        ref_counts = torch.zeros(nr // 128, dtype=torch.int64, device=dev)
        ref(*args, counts=ref_counts)
        walk = lambda: woop.woop_list(rays, w, lo, hi, *lst, **kw)
        full_walk = lambda: woop._walk(*args, s, anyhit=anyhit)
        k1 = lambda: ref(*args)
        a1, b1, c1, c2, b2, a2 = (cuda_time(walk, 10), cuda_time(full_walk, 10), cuda_time(k1, 10),
                                  cuda_time(k1, 10), cuda_time(full_walk, 10), cuda_time(walk, 10))
        nb, m = nr // 128, blo.shape[0]
        per_pair = OPS_ANY if anyhit else OPS_NEAREST
        nbytes = nr * 32 + nr * (1 if anyhit else 8) + nb * m * 8 + (w.shape[0] // 3) * 48 + m * 24
        bnd, by = bound_ms(pairs * per_pair, nbytes)
        fewest = min(pairs, int(ref_counts.sum()))
        bnd_few, _ = bound_ms(fewest * per_pair, nbytes)
        out[label] = {"ms": (a1 + a2) / 2, "with_list_ms": (b1 + b2) / 2,
                      "k1_ms": (c1 + c2) / 2, "bound_ms": bnd, "bound_by": by,
                      "bound_fewest_ms": bnd_few, "pairs": pairs,
                      "ref_pairs": int(ref_counts.sum()), "visits": visits, "cvisits": cvisits,
                      "lane_use": split["lane_use"], "cycle_shares": split["shares"], "rays": nr}
        rname = "K2" if anyhit else "K1"
        log(f"phase 13 timing {label} {nr} rays [{smi}]: walker {a1:.3f} / {a2:.3f} ms, "
            f"with its list (visit list + walker) {b1:.3f} / {b2:.3f} ms, {rname} {c1:.3f} / "
            f"{c2:.3f} ms; pairs tested {pairs} ({rname} {int(ref_counts.sum())}), tile visits "
            f"{visits}, compacted {cvisits} ({cvisits / max(visits, 1):.4f}); bound {bnd:.4f} ms "
            f"({by}), {bnd_few:.4f} at the fewest pairs; lane use {split['lane_use']:.4f}")
    # F4 under the node schedule: without the proxy pre-pass and with it
    # (K2 on the proxy table, then the walker warm-started), in turns
    rays, proxy, shadow = woop.k2_inputs(accel, *pops["shade"][:2], full(1e-3, W * H),
                                         pops["shade"][2])
    s = S(node_clusters=8)
    walk = lambda: woop._walk(rays, *shadow, s, anyhit=True)
    with_pre = lambda: woop._walk(rays, *shadow, s, anyhit=True,
                                  occluded_in=woop.woop_any(rays, *proxy))
    errs.append(check_k2(f"city1600 shade {W * H} F4 walker P=8 without vs with the pre-pass",
                         walk(), with_pre(), phase=13))
    a1, b1, b2, a2 = (cuda_time(walk, 10), cuda_time(with_pre, 10), cuda_time(with_pre, 10),
                      cuda_time(walk, 10))
    out["f4"] = {"without_ms": (a1 + a2) / 2, "with_ms": (b1 + b2) / 2}
    log(f"phase 13 F4 shade {W * H} rays P=8 [{smi}]: with its list {a1:.3f} / {a2:.3f} ms; "
        f"with the proxy pre-pass (K2 proxy + walker warm-started) {b1:.3f} / {b2:.3f} ms")
    # the plain versions' time, on the subset
    args = woop.k1_inputs(accel, *_sub(pops["bounce_target"]))
    p1 = cuda_time(lambda: woop.intersect_woop_reference(args[0], args[1]), 1)
    out["plain_ms_subset"] = p1
    out["max_abs_err"] = max(errs)
    log(f"phase 13 plain version on {SUBSET} target-sorted bounce rays: {p1:.1f} ms; the "
        f"walker: {out['ctas_per_sm']} CTAs of 128 threads an SM")
    return out


def phase14(dev, smi, city1600):
    """6 frames at 1080p on city(1600, 7) for each schedule and for the
    default routes, with exact launch counts a frame; the LDR images
    against the default routes'."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    bundle, accel, config, _ = city1600
    S = woop.TraceSchedule
    runs = [
        ("pt_1600", "pt", None, {"woop_nearest": 5}),
        ("restir_1600", "restir", None, {"woop_nearest": 2, "woop_any": 1}),
        ("pt_1600_target", "pt", S(target_key=True),
         {"woop_nearest": 1, "target_keys": 4, "visit_list": 4, "woop_list": 4}),
        ("pt_1600_nodes_compact", "pt", S(True, 8, 32),
         {"target_keys": 4, "visit_list": 5, "woop_list": 5, "woop_list_nodes": 5,
          "woop_list_compact": 5}),
        ("restir_1600_nodes", "restir", S(node_clusters=8),
         {"visit_list": 3, "woop_list": 3, "woop_list_nodes": 3, "woop_list_any": 1}),
    ]
    per_path, ldr, timing = {}, {}, {}
    for path, integrator, sched, expect in runs:
        cfg = config._replace(integrator=integrator)
        rcfg = ReSTIRConfig() if integrator == "restir" else None
        state = init_state(cfg, rcfg, device=dev)
        reset_launches()
        frame_ms = []
        for i in range(6):
            before = launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, out = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=i), cfg,
                                      state, rcfg, schedule=sched)
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            got = {k: v - before[k] for k, v in launches().items()}
            if got != {**{k: 0 for k in got}, **expect}:
                raise AssertionError(f"{path} frame {i}: launched {got}, expected {expect}")
        per_path[path] = launches()
        for name, x in (("ldr", out["ldr"]), ("hdr", out["hdr"]),
                        ("accum_irradiance", state.accum_irradiance)):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"{path} {name} is not finite")
        if tuple(out["ldr"].shape) != (H, W, 3) or float(out["ldr"].std()) <= 0.0:
            raise AssertionError(f"{path} ldr has the wrong shape or is constant")
        ldr[path] = out["ldr"]
        steady = float(np.mean(frame_ms[2:]))
        timing[path] = (frame_ms[0], steady)
        same = ""
        if sched is not None:
            ref = ldr[f"{integrator}_1600"]
            diff = (out["ldr"] - ref).abs()
            share = float((diff.amax(-1) <= PIX_TOL).float().mean())
            mean = float(diff.mean())
            same = (f"; against schedule=None: bit-identical {bool(torch.equal(out['ldr'], ref))}, "
                    f"pixels within {PIX_TOL} {share:.5f}, mean |d| {mean:.3e}")
            if share < PIX_SHARE or mean >= MEAN_TOL:
                raise AssertionError(f"{path}: LDR differs from the default routes'")
        log(f"phase 14 {path} {W}x{H} schedule={tuple(sched) if sched else None} [{smi}]: "
            f"launches {per_path[path]}; cold {frame_ms[0]:.1f} ms, steady {steady:.1f} ms/frame "
            f"(frames {', '.join(f'{x:.1f}' for x in frame_ms)}){same}")
    f4 = {path: prepass_ab(14, path, bundle, accel, config._replace(integrator="restir"), dev, smi,
                           schedule=sched)
          for path, integrator, sched, _ in runs if integrator == "restir"}
    return per_path, timing, f4


def phase15(dev):
    """2 PT and 2 ReSTIR frames of city(1600, 7) at 32×18 under
    TraceSchedule(True, 8, 32): the CPU oracle against the card."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    bundle = city(**CITY1600, device="cpu")
    sched = woop.TraceSchedule(True, 8, 32)
    for name, cfg, rcfg in (
        ("pt", RenderConfig(width=32, height=18, spp=SPP, max_path_length=MPL), None),
        ("restir", RenderConfig(width=32, height=18, integrator="restir"), ReSTIRConfig()),
    ):
        _, out_cpu = render_sequence(bundle, cfg, frames=2, mcpg_config=rcfg, device="cpu",
                                     schedule=sched)
        before = launches()
        _, out_gpu = render_sequence(bundle, cfg, frames=2, mcpg_config=rcfg, schedule=sched)
        got = {k: v - before[k] for k, v in launches().items()}
        if got["woop_nearest"] or not got["woop_list_nodes"] or (name == "pt") != bool(
                got["target_keys"]):
            raise AssertionError(f"city1600 {name} 32x18 under {sched} launched {got}")
        diff = (out_cpu["ldr"] - out_gpu["ldr"].cpu()).abs()
        share = float((diff.amax(-1) <= PIX_TOL).float().mean())
        mean = float(diff.mean())
        log(f"phase 15 city1600 {name} cpu vs cuda 32x18 x2 frames under {tuple(sched)}: "
            f"launches {got}; pixels within {PIX_TOL} {share:.5f}, mean |d| {mean:.3e}, "
            f"max |d| {float(diff.max()):.3e}")
        if share < PIX_SHARE or mean >= MEAN_TOL:
            raise AssertionError(f"city1600 {name}: CPU and card LDR images disagree")


# the alpha walk's instances: K1's walk (index order) and K3's (node lists)
ALPHA_WALKS = ("woop_nearest_alpha", "woop_stream_alpha")


@contextlib.contextmanager
def trace_route(stream):
    """While open, every nearest-hit trace goes to K3 (``stream``) or to K1,
    whatever its table's size (``woop.streamed`` answers ``stream``)."""
    from merian_quake_tpu_torch.accel import woop

    plain = woop.streamed
    woop.streamed = lambda w: stream
    try:
        yield
    finally:
        woop.streamed = plain


def round_loop(accel, atlas, o, d, t_min, t_max, stream, on_device=False):
    """trace_nearest's round loop on the card, the one the list walker's
    route keeps: ``intersect._alpha_round`` a round over K1, or K3 with
    ``stream``. Eagerly it stops after the round that leaves no ray live
    (a host read a round); ``on_device`` runs all MAX_INTERSECTIONS rounds
    and reads nothing, as under ``alpha_loop_on_device``. Returns the
    HitRecord."""
    import importlib

    from merian_quake_tpu_torch.models import materials

    imod = importlib.import_module("merian_quake_tpu_torch.accel.intersect")
    n = o.shape[0]
    full = lambda v, dt=torch.float32: torch.full((n,), v, dtype=dt, device=o.device)
    res = imod.HitRecord(full(3e38), full(-1, torch.int32), full(0.0), full(0.0))
    active, cur = full(True, torch.bool), t_min
    with trace_route(stream):
        for _ in range(materials.MAX_INTERSECTIONS):
            if not on_device and not bool(active.any()):
                break
            active, cur, res = imod._alpha_round(accel, atlas, o, d, active, cur, t_max, res)
    return res


def plane_stack(dev):
    """Seven two-sided planes across a box, every texel of their texture
    transparent: a ray along +x is rejected by each plane it meets, so
    after MAX_INTERSECTIONS rounds it ends unhit."""
    from merian_quake_tpu_torch.models.atlas import pack_textures
    from merian_quake_tpu_torch.models.procedural import _const_tex, _SoupBuilder

    b = _SoupBuilder()
    for k in range(7):
        x = 10.0 + 10.0 * k
        b.quad((x, 0, 0), (0, 100.0, 0), (0, 0, 100.0), texnum=1)
        b.quad((x, 0, 0), (0, 0, 100.0), (0, 100.0, 0), texnum=1)
    atlas = pack_textures([_const_tex((255, 255, 255), 1), _const_tex((90, 90, 90), alpha=0)],
                          device=dev)
    return b.build(dev), atlas


def same_hits(name, got, refs, n):
    """Hold an alpha walk's (t, tri, u, v) against each reference of
    ``refs`` ({name: (t, tri, u, v)}) bit for bit on the first ``n`` rays
    (the floats by their bits). Returns the largest |t difference| (0)."""
    torch.cuda.synchronize()
    bits = lambda x: x[:n].view(torch.int32)
    for rname, ref in refs.items():
        differ = [int((bits(a) != bits(b)).sum()) for a, b in zip(got, ref)]
        log(f"phase 39 {name} against {rname}: rays={n} hits={int((got[1][:n] >= 0).sum())} "
            f"t, tri, u, v differ={differ}")
        if any(differ):
            raise AssertionError(f"phase 39 {name}: differs from {rname} on {differ} rays")
    return max(float((got[0][:n] - ref[0][:n]).abs().max()) for ref in refs.values())


def alpha_work(kernel, args, tables):
    """Run an alpha walk once with its per-warp counts; returns (ops, bytes,
    rounds a warp i64[n_pad / 32]): the pairs its lanes tested over all
    rounds times the FP32 operations a pair, and the rays in, results out,
    table rows (48 B a triangle), boxes, the alpha test's columns (the
    vertices, st, texnum, needs_alpha: 65 B a triangle), the atlas's rect
    table and its texels' alpha, each read once."""
    rays, w, lo = args[0], args[1], args[2]
    n = rays.shape[1]
    counts = torch.zeros((n // 32, 2), dtype=torch.int64, device=rays.device)
    kernel(*args, tables, counts=counts)
    T = w.shape[0] // 3
    atlas = tables.atlas
    nbytes = (n * 32 + n * 16 + T * 48 + lo.shape[0] * 24 + T * 65 + atlas.table.numel() * 4
              + atlas.data.shape[0] * atlas.data.shape[1] * 4)
    return float(counts[:, 1].sum()) * OPS_NEAREST, nbytes, counts[:, 0]


def alpha_population(label, accel, atlas, o, d, t_min, t_max, smi, timed=False):
    """Both alpha walks on one population: against the plain version on a
    SUBSET-ray slice (its middle) and against the eager round loop over K1
    (the resident instance) and over K3 (the streamed one) on every ray.
    ``timed``: each instance timed in turns with its round loop, eager and
    on the device, by CUDA events, with its bound and the rounds its warps
    walked. Returns ({instance: reading}, the largest |t difference|)."""
    from merian_quake_tpu_torch.accel import woop

    n = o.shape[0]
    tables = woop.alpha_tables(accel, atlas)
    args = woop.k1_inputs(accel, o, d, t_min, t_max)
    s0 = max(0, n // 2 - SUBSET // 2)
    sub = slice(s0, min(n, s0 + SUBSET))
    m = sub.stop - sub.start
    sub_args = woop.k1_inputs(accel, o[sub].contiguous(), d[sub].contiguous(),
                              t_min[sub].contiguous(), t_max[sub].contiguous())
    plain, plain_ms = timed_call(lambda: woop.woop_alpha_reference(sub_args[0], sub_args[1],
                                                                   tables, n=m))
    plain = plain[0]
    out, errs = {}, []
    for name, stream in zip(ALPHA_WALKS, (False, True)):
        kernel = getattr(woop, name)
        errs.append(same_hits(f"{label} {m} {name}", kernel(*sub_args, tables, n=m),
                              {"woop_alpha_reference": plain}, m))
        walk = lambda: kernel(*args, tables, n=n)
        eager = lambda: round_loop(accel, atlas, o, d, t_min, t_max, stream)
        errs.append(same_hits(f"{label} {n} {name}", walk(),
                              {f"the eager round loop over {'K3' if stream else 'K1'}": eager()},
                              n))
        rec = {"rays": n, "plain_ms": plain_ms, "plain_rays": m}
        if timed:
            on_dev = lambda: round_loop(accel, atlas, o, d, t_min, t_max, stream, on_device=True)
            k1, e1, v1, v2, e2, k2 = (cuda_time(f, 5) for f in (walk, eager, on_dev, on_dev,
                                                                eager, walk))
            # the same walk's kernel alone, one round without the alpha test
            one = woop.woop_stream if stream else woop.woop_nearest
            one_ms = cuda_time(lambda: one(*args), 5)
            ops, nbytes, rounds = alpha_work(kernel, args, tables)
            live = rounds[: -(-n // 32)]
            hist = [int((live == r).sum()) for r in range(int(live.max()) + 1)]
            rec.update(ms=(k1 + k2) / 2, eager_loop_ms=(e1 + e2) / 2,
                       on_device_loop_ms=(v1 + v2) / 2, one_round_kernel_ms=one_ms,
                       pairs=ops / OPS_NEAREST,
                       warp_rounds_mean=float(live.float().mean()), warp_rounds_hist=hist)
            rec["bound_ms"], rec["bound_by"] = bound_ms(ops, nbytes)
            log(f"phase 39 timing {label} {n} rays {name} [{smi}]: alpha walk {k1:.3f} / {k2:.3f} "
                f"ms, the round loop over {'K3' if stream else 'K1'} eager {e1:.3f} / {e2:.3f} ms, "
                f"on the device (all rounds) {v1:.3f} / {v2:.3f} ms; {'K3' if stream else 'K1'} "
                f"alone (one round, no alpha test) {one_ms:.3f} ms; plain version {plain_ms:.1f} "
                f"ms on {m} rays; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
                f"{ops / OPS_NEAREST:.4g} pairs over all rounds); rounds a warp: mean "
                f"{rec['warp_rounds_mean']:.3f}, warps by rounds walked {hist}")
        out[name] = rec
    return out, max(errs)


def phase39(dev, smi, dungeon):
    """The alpha walk: both instances bit for bit against the plain version
    and the eager round loop on the grate soup (with a dead warp and
    padding), a stack of seven rejecting planes (every ray unhit after the
    cap, every warp walking MAX_INTERSECTIONS rounds), the court's 1080p
    primary rays and one bounce population, and the live dungeon's
    refreshed tables (``dungeon``: phase 30's, as phase 31 leaves it in a
    whole run); timed on the court (K1's
    walk) and the dungeon (K3's) against the round loop, eager and on the
    device. Returns the kernels' readings."""
    import types

    from merian_quake_tpu_torch.accel import build_accel, woop
    from merian_quake_tpu_torch.models import materials

    full = lambda v, k: torch.full((k,), v, device=dev)
    errs, readings = [], {}
    rng = np.random.default_rng(39)
    # the grate soup: random rays in the room, warp 2 dead, padding
    scene, atlas = grate_soup(dev)
    acc = build_accel(scene, atlas)
    n = 4096 + 37
    o = torch.from_numpy(rng.uniform([2, 2, 2], [198, 98, 98], (n, 3)).astype(np.float32)).to(dev)
    d = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(n, 3)).astype(np.float32)).to(dev), dim=-1)
    t_max = full(1e4, n)
    t_max[64:96] = -1.0
    r, e = alpha_population("grate soup", acc, atlas, o, d, full(0.0, n), t_max, smi)
    errs.append(e)
    # seven rejecting planes: every ray unhit after MAX_INTERSECTIONS rounds
    scene, atlas = plane_stack(dev)
    acc = build_accel(scene, atlas)
    n = 1024
    yz = torch.from_numpy(rng.uniform(2.0, 98.0, (n, 2)).astype(np.float32)).to(dev)
    o = torch.cat([torch.zeros((n, 1), device=dev), yz], 1).contiguous()
    d = torch.tensor([[1.0, 0.0, 0.0]], device=dev).expand(n, 3).contiguous()
    _, e = alpha_population("seven planes", acc, atlas, o, d, full(0.0, n), full(1e4, n), smi)
    errs.append(e)
    args = woop.k1_inputs(acc, o, d, full(0.0, n), full(1e4, n))
    tables = woop.alpha_tables(acc, atlas)
    for name in ALPHA_WALKS:
        kernel = getattr(woop, name)
        hit = kernel(*args, tables, n=n)[1]
        rounds = alpha_work(kernel, args, tables)[2]
        if bool((hit >= 0).any()) or bool((rounds != materials.MAX_INTERSECTIONS).any()):
            raise AssertionError(f"phase 39 seven planes {name}: {int((hit >= 0).sum())} hits, "
                                 f"rounds a warp {rounds.unique().tolist()}")
    log(f"phase 39 seven planes: every ray unhit, every warp walked "
        f"{materials.MAX_INTERSECTIONS} rounds, both instances")

    # the court at 1080p: primary rays and one bounce population as it lies
    c_bundle, c_accel, c_cfg = court(dev)
    po, pd = primary_rays(c_bundle, c_accel, dev)
    bo, bd, bt = bounce_rays(c_bundle, c_accel, c_cfg, dev)
    nf = po.shape[0]
    court_pops = {}
    for pop, (o, d, t_max) in (("primary", (po, pd, full(materials.T_MAX, nf))),
                               ("bounce", (bo, bd, bt))):
        court_pops[pop], e = alpha_population(f"court {pop}", c_accel, c_bundle.atlas, o, d,
                                         full(0.0, nf), t_max, smi, timed=True)
        errs.append(e)
    # the live dungeon's refreshed tables (K3's route): its frame's primary
    # and bounce rays and rays aimed at the monsters
    la, bundle = dungeon.la, types.SimpleNamespace(uniforms=dungeon.uniforms,
                                                   atlas=dungeon.live.gs.static_bundle.atlas)
    if not woop.streamed(la.accel.woop_w):
        raise AssertionError("the live dungeon's table is not streamed (K3)")
    po, pd = primary_rays(bundle, la.accel, dev)
    bo, bd, bt = bounce_rays(bundle, la.accel, dungeon.config._replace(integrator="pt"), dev)
    ao, ad = aimed_rays(la.accel, la.n_static, SUBSET, 39)
    live_pops = {}
    for pop, (o, d, t_max) in (("primary", (po, pd, full(materials.T_MAX, nf))),
                               ("bounce", (bo, bd, bt)),
                               ("aimed at the monsters", (ao, ad, full(1e4, SUBSET)))):
        live_pops[pop], e = alpha_population(f"live dungeon {pop}", la.accel, bundle.atlas, o, d,
                                        full(0.0, o.shape[0]), t_max, smi,
                                        timed=pop != "aimed at the monsters")
        errs.append(e)
    for name, pops, scene, nc in ((ALPHA_WALKS[0], court_pops, "court", c_accel.num_clusters),
                                  (ALPHA_WALKS[1], live_pops, "live dungeon",
                                   la.accel.num_clusters)):
        mix = lambda key: (pops["primary"][name][key] + 4 * pops["bounce"][name][key]) / 5
        readings[name] = {
            "ms": mix("ms"), "plain_ms": mix("plain_ms"), "plain_rays": SUBSET,
            "bound_ms": mix("bound_ms"), "bound_by": pops["bounce"][name]["bound_by"],
            "eager_loop_ms": mix("eager_loop_ms"), "on_device_loop_ms": mix("on_device_loop_ms"),
            "rays": nf, "scene": scene, "ctas_per_sm": woop.ctas_per_sm(name, nc),
            "court": {p: v[name] for p, v in court_pops.items()},
            "live_dungeon": {p: v[name] for p, v in live_pops.items()}}
    readings["max_abs_err"] = max(errs)
    return readings
