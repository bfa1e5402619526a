#!/usr/bin/env python3
"""K1, K2, K3, K4/K5, K6/K7 and K8 of this checkout against the same kernels of
another checkout, on one GPU: equal results, and their times in turns.

    python3 scripts/ab_trace_kernels.py --parent DIR [--map] [--reps 10] [--only K4,K5] [--frames]

DIR is another checkout of the repo, for example the parent commit
unpacked with ``git archive``, or a copy of this one whose ``csrc/`` holds
other constants or another walk order (a variant). The kernel sources of
both checkouts are built with nvcc for sm_90a into this checkout's
``_build/`` (a library's name carries a hash of its sources, so the two
builds never collide) and launched on the same inputs. A kernel that is
an instance of the walk of ``csrc/woop_walk.cuh`` is launched through
this checkout's wrappers (which read the node sizes from each library);
an older one (a CTA of 128 rays walking the clusters, entry points that
take ``woop_w`` and the cluster bounds) through this script's own calls
with that argument list; K8 likewise (the first design takes the
f32[16, T] triangle rows, this one ``dense.mt_table``'s f32[T, 12]). The
inputs: city's (16,640 triangles) 1080p primary rays and sorted
first-bounce rays (K1, and K3 forced on the same table), and the ReSTIR
shade pass's shadow rays (K2 on the proxy table, on the shadow table, and
on the shadow table warm-started by the proxy pre-pass; K3's any-hit
form); the court's shade rays (K2 on its shadow table). With ``--map``
the map scene (``city(28000, 11)``, 281,536 triangles) adds its primary,
bounce and shadow rays through K3, its proxy pre-pass through K2, and K8
on 65,536 of its primary rays (those chip_smoke.py phase 9 takes).
K6/K7, the list walker (``csrc/woop_list.cu``), runs on city(1600, 7)
(252 clusters, so the target key applies) on the populations
chip_smoke.py phase 13 takes: the target-sorted first bounce at P = 1, P
= 8 and (P = 8, compact 32), the primary rays at (8, 32), the shade
pass's shadow rays any-hit at P = 8, and the 4,147,200 guided rays of an
MCPG bounce segment (a frame after 4 warm-up frames), target-sorted, at
(8, 32); each on the list K5 gives it (``woop.visit_list``). K4 and K5
(``csrc/woop_keys.cu``) run on city(1600, 7) too: K4 on the first bounce
in pixel order (as the frames key it) and target-sorted, K5 in the
walker's mode on the target-sorted bounce over the 252 cluster boxes and
32 node boxes of 8, in the JAX package's mode on the bounce, and the
visit list on the target-sorted bounce (a checkout without the fused
entry makes it as K5 + torch's stable row sort); each also on
chip_smoke.py's edge-case boxes and rays; K4 beside the change's slab
counts and its bounds at 24 and 18 operations a slab and at the slabs it
computed. An older K4 (no ``counts``) is launched through this script's
own call. ``--frames`` adds city(1600)'s 1080p frames that launch K4 and
the visit list (PT under the target key, PT and MCPG under (True, 8,
32)) with each checkout's kernels in turns, on the host clock and the
device's (the profiler's kernel time a frame). A walker of
the walk (``woop_walk.cuh`` in its source) is launched through
``woop.woop_list``, an older one through this script's own call with its
argument list (``woop_w`` and the node boxes). Beside each: the list's
time (the visit list) and K1's (K2's) on the same rays, the pairs
each tested, the bound at its own pairs and at the fewest pairs
measured, and the change's profile (cycle shares, lane use); then the
compaction's lane limit in turns (:func:`woop.compact_lanes` of compact
32, 96, 128). First it prints each Woop kernel's registers, stack frame
and spill bytes, as ptxas reported them, for both checkouts. Each
kernel's output must equal the other checkout's bit for bit (a walker's: on every ray, and the script goes on to the next
population and fails at the end). Times are CUDA-event means over
``--reps`` launches (K8: 3), taken in the turns parent, change, change,
parent. Prints one line a measurement with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (ray populations, cuda_time)
from merian_quake_tpu_torch import kernels  # noqa: E402
from merian_quake_tpu_torch.accel import build_accel, dense, woop  # noqa: E402
from merian_quake_tpu_torch.accel.build import scene_features  # noqa: E402
from merian_quake_tpu_torch.models.procedural import city, outdoor_court  # noqa: E402
from merian_quake_tpu_torch.models.types import RenderConfig  # noqa: E402
from merian_quake_tpu_torch.renderer import init_state, render_frame  # noqa: E402

SOURCES = ("woop_nearest", "woop_any", "woop_stream", "woop_keys", "woop_list", "mt_dense")
# the arguments of a pre-walk entry point: (rays, n_pad, woop_w, lo, hi,
# nc, block, out0, out1, counts, stream)
OLDER_ARGS = (woop._P, woop._I64, woop._P, woop._P, woop._P, woop._INT, woop._INT, woop._P,
              woop._P, woop._P, woop._P)
# the first list walker's: (rays, n_pad, woop_w, lo, hi, nc, te_s, order, m,
# node_lo, node_hi, P, compact, anyhit, occ_in, out_t, out_tri, out_occ,
# counts u64[n_pad / 128, 3], stream)
OLDER_LIST_ARGS = (woop._P, woop._I64, woop._P, woop._P, woop._P, woop._INT, woop._P, woop._P,
                   woop._INT, woop._P, woop._P, woop._INT, woop._INT, woop._INT, woop._P, woop._P,
                   woop._P, woop._P, woop._P, woop._P)
# the first K4's: (rays, n_pad, lo, hi, nc, out, stream)
OLDER_KEYS_ARGS = (woop._P, woop._I64, woop._P, woop._P, woop._INT, woop._P, woop._P)
# the first K8's: (rays, n_pad, tris f32[16, T], T, block, t, tri, u, v, stream)
OLDER_K8_ARGS = (woop._P, woop._I64, woop._P, woop._I64, woop._INT, woop._P, woop._P, woop._P,
                 woop._P, woop._P)


def use(csrc: str) -> dict:
    """Have every wrapper launch the kernels built from ``csrc``; returns
    which of its kernels are the current designs: ``walk`` (K1 and K3 are
    the walk), ``k2`` (K2 is too), ``list`` (the list walker is too),
    ``k8`` (K8 takes mt_table's layout), ``keys`` (K4 takes ``counts`` and
    the visit list is one launch)."""
    kernels.CSRC_DIR = csrc
    kernels.load_library.cache_clear()
    read = lambda name: open(os.path.join(csrc, name)).read()
    return {"walk": os.path.exists(os.path.join(csrc, "woop_walk.cuh")),
            "k2": "woop_walk.cuh" in read("woop_any.cu"),
            "list": "woop_walk.cuh" in read("woop_list.cu"),
            "k8": "mt_resolve_kernel" in read("mt_dense.cu"),
            "keys": "mq_visit_list" in read("woop_keys.cu")}


def older(name, rays, w, lo, hi, occ=None, anyhit=False):
    """K1, K2 or K3 of a checkout from before the walk (the older argument
    list)."""
    n, dev = rays.shape[1], rays.device
    if anyhit:
        out = torch.empty(n, dtype=torch.bool, device=dev)
        outs = (None if occ is None else occ.data_ptr(), out.data_ptr())
    else:
        out = (torch.empty(n, dtype=torch.float32, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev))
        outs = (out[0].data_ptr(), out[1].data_ptr())
    entry = "mq_woop_stream_any" if anyhit and name == "woop_stream" else None
    woop._call(woop._kernel_lib(name, entry, OLDER_ARGS), dev, rays.data_ptr(), n,
               w.data_ptr(), lo.data_ptr(), hi.data_ptr(), lo.shape[0], woop.RAY_BLOCK, *outs, None)
    return out


def older_k8(rays, tris):
    """The first K8 on the f32[16, T] triangle rows."""
    n, dev = rays.shape[1], rays.device
    out = (torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev))
    woop._call(woop._kernel_lib("mt_dense", None, OLDER_K8_ARGS), dev, rays.data_ptr(), n,
               tris.data_ptr(), tris.shape[1], woop.RAY_BLOCK, *(x.data_ptr() for x in out))
    return out


def older_keys(rays, lo, hi):
    """The first K4, whose entry point takes no ``counts``."""
    out = torch.empty(rays.shape[1], dtype=torch.int32, device=rays.device)
    woop._call(woop._kernel_lib("woop_keys", "mq_target_keys", OLDER_KEYS_ARGS), rays.device,
               rays.data_ptr(), rays.shape[1], lo.data_ptr(), hi.data_ptr(), lo.shape[0],
               out.data_ptr())
    return out


def visit_list_of(c, rays, lo, hi):
    """The visit list as a checkout makes it: one launch, or K5 in its
    walker mode and torch's stable row sort."""
    if c["keys"]:
        return woop.visit_list(rays, lo, hi)
    te_s, order = torch.sort(woop.te_union(rays, lo, hi, slack=True), dim=1, stable=True)
    return te_s, order.int()


def older_list(rays, w, lo, hi, lst, nodes, compact, anyhit=False, occ=None, counts=None):
    """The first list walker (a CTA of 128 rays walking its block's list),
    with its own argument list; ``counts`` None or int64[n_pad / 128, 3]."""
    n, dev = rays.shape[1], rays.device
    ptr = lambda x: None if x is None else x.data_ptr()
    nlo, nhi = woop.node_bounds(lo, hi, nodes) if nodes > 1 else (None, None)
    if anyhit:
        out = torch.empty(n, dtype=torch.bool, device=dev)
        outs = (None, None, out.data_ptr())
    else:
        out = (torch.empty(n, dtype=torch.float32, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev))
        outs = (out[0].data_ptr(), out[1].data_ptr(), None)
    if counts is not None:
        counts.zero_()
    woop._call(woop._kernel_lib("woop_list", None, OLDER_LIST_ARGS), dev, rays.data_ptr(), n,
               w.data_ptr(), lo.data_ptr(), hi.data_ptr(), lo.shape[0], lst[0].data_ptr(),
               lst[1].data_ptr(), lst[0].shape[1], ptr(nlo), ptr(nhi), nodes, compact,
               int(anyhit), ptr(occ), *outs, ptr(counts))
    return out


def spills(name):
    """Each kernel of library ``name`` (as built from the checkout in use)
    with the registers, stack frame and spill bytes ptxas reported for
    it."""
    out, fn, frame = [], None, ""
    with open(kernels.library_path(name) + ".log") as f:
        for line in f:
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
            elif fn and "spill" in line:
                frame = line.strip()
            elif fn and "Used" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                out.append(f"{fn}: {regs} registers, {frame}")
                fn = None
    return out


def same(name, a, b) -> None:
    torch.cuda.synchronize()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: the two checkouts' kernels differ")


def k2_case(name, rays, table, occ=None):
    """(name, fn): K2 on one table, the walk's instance or the older one."""
    return (name, lambda c: woop.woop_any(rays, *table, occ) if c["k2"]
            else older("woop_any", rays, *table, occ=occ, anyhit=True))


def cases(dev, scene_kw, with_k1_k2):
    """(name, fn) pairs on one scene's 1080p rays; fn(c) launches the
    kernel of the checkout in use (``c``: what :func:`use` returned)."""
    bundle = city(**scene_kw, device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    config = RenderConfig(width=chip_smoke.W, height=chip_smoke.H, spp=chip_smoke.SPP,
                          max_path_length=chip_smoke.MPL, features=feats)
    n = chip_smoke.W * chip_smoke.H
    full = lambda v, k=n: torch.full((k,), v, device=dev)
    po, pd = chip_smoke.primary_rays(bundle, accel, dev)
    bo, bd, bt = chip_smoke.bounce_rays(bundle, accel, config, dev)
    perm = woop.sort_perm(accel, bo, bd, bt)
    bo, bd, bt = bo[perm].contiguous(), bd[perm].contiguous(), bt[perm].contiguous()
    so, sd, st = chip_smoke.shade_rays(bundle, accel, config, dev)
    prim = woop.k1_inputs(accel, po, pd, full(0.0), full(1e4))
    boun = woop.k1_inputs(accel, bo, bd, full(0.0), bt)
    rays, proxy, shadow = woop.k2_inputs(accel, so, sd, full(1e-3), st)
    pre = woop.intersect_woop_any_reference(rays, proxy[0])
    tag = "map" if scene_kw else "city"
    k1 = lambda a: lambda c: woop.woop_nearest(*a) if c["walk"] else older("woop_nearest", *a)
    k3 = lambda a: lambda c: woop.woop_stream(*a) if c["walk"] else older("woop_stream", *a)
    out = [k2_case(f"{tag} K2 proxy", rays, proxy)]
    if with_k1_k2:
        out += [(f"{tag} K1 primary", k1(prim)), (f"{tag} K1 bounce", k1(boun)),
                k2_case(f"{tag} K2 shadow", rays, shadow),
                k2_case(f"{tag} K2 shadow after proxy", rays, shadow, pre)]
    out += [(f"{tag} K3 primary", k3(prim)), (f"{tag} K3 bounce", k3(boun)),
            (f"{tag} K3 shadow after proxy",
             lambda c: woop.woop_stream(rays, *shadow, anyhit=True, occluded_in=pre) if c["walk"]
             else older("woop_stream", rays, *shadow, occ=pre, anyhit=True))]
    if scene_kw:
        mid = slice(n // 2, n // 2 + chip_smoke.SUBSET)
        k8_rays = woop._pack_rays(po[mid].contiguous(), pd[mid].contiguous(),
                                  full(0.0, chip_smoke.SUBSET), full(1e4, chip_smoke.SUBSET),
                                  woop.RAY_BLOCK)
        tris = dense.pack_tris(accel.scene.v0, accel.scene.v1, accel.scene.v2, accel.candidate)
        table = dense.scene_table(accel)
        out.append((f"{tag} K8 primary {chip_smoke.SUBSET}",
                    lambda c: dense.mt_dense(k8_rays, table) if c["k8"] else older_k8(k8_rays, tris)))
    return out


def court_cases(dev):
    """K2 on the court's 1080p shade rays (its shadow table; no proxy)."""
    bundle = outdoor_court(device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    config = RenderConfig(width=chip_smoke.W, height=chip_smoke.H, spp=chip_smoke.SPP,
                          max_path_length=chip_smoke.MPL, features=feats)
    so, sd, st = chip_smoke.shade_rays(bundle, accel, config, dev)
    rays, _, shadow = woop.k2_inputs(accel, so, sd, torch.full_like(st, 1e-3), st)
    return [k2_case("court K2 shadow", rays, shadow)]


def list_populations(dev):
    """The walker's populations on city(1600, 7) at 1080p: (name, (rays, w,
    lo, hi), P, compact, anyhit)."""
    bundle, accel, config, pops = chip_smoke.city1600(dev)
    n = chip_smoke.W * chip_smoke.H
    # the guided rays of the first MCPG bounce segment after 4 frames,
    # target-sorted as the schedule sorts them
    cfg, mcfg = chip_smoke.mcpg_scene_config(config)
    state = init_state(cfg, mcfg, device=dev)
    for f in range(4):
        state, _ = render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=f), cfg,
                                state, mcfg)
    go, gd, gt = chip_smoke.guided_population(bundle, accel, cfg, mcfg, state, 4)[1][0]
    perm = torch.sort(woop.target_sort_key(accel, go, gd, gt), stable=True).indices
    guided = (go[perm].contiguous(), gd[perm].contiguous(), torch.zeros_like(gt),
              gt[perm].contiguous())
    so, sd, st = pops["shade"]
    rays, _, shadow = woop.k2_inputs(accel, so, sd, torch.full((n,), 1e-3, device=dev), st)
    k1 = lambda pop: woop.k1_inputs(accel, *pop)
    return [("bounce_target P=1", k1(pops["bounce_target"]), 1, 0, False),
            ("bounce_target P=8", k1(pops["bounce_target"]), 8, 0, False),
            ("bounce_target P=8 compact=32", k1(pops["bounce_target"]), 8, 32, False),
            ("primary P=8 compact=32", k1(pops["primary"]), 8, 32, False),
            ("shade any-hit P=8", (rays, *shadow), 8, 0, True),
            (f"guided {guided[0].shape[0]} P=8 compact=32", k1(guided), 8, 32, False)]


def list_ab(dev, parent, change, reps, smi) -> int:
    """K6/K7 of the two checkouts on :func:`list_populations`, in turns,
    with the readings beside them; returns the populations on which the
    two differ."""
    fails = 0
    for name, (rays, w, lo, hi), nodes, compact, anyhit in list_populations(dev):
        n, nb = rays.shape[1], rays.shape[1] // woop.RAY_BLOCK
        blo, bhi = woop.node_bounds(lo, hi, nodes) if nodes > 1 else (lo, hi)
        lst = woop.visit_list(rays, blo, bhi)
        kw = dict(node_lo=blo, node_hi=bhi, nodes=nodes) if nodes > 1 else {}

        def fn(c, counts=None, compact=compact):
            if c["list"]:
                return woop.woop_list(rays, w, lo, hi, *lst, compact=compact, anyhit=anyhit,
                                      counts=counts, **kw)
            return older_list(rays, w, lo, hi, lst, nodes, compact, anyhit, counts=counts)

        label = f"city1600 K{7 if compact else 6} {name}"
        base, new = fn(use(parent)), fn(use(change))
        torch.cuda.synchronize()
        pairs_out = zip(base if isinstance(base, tuple) else (base,),
                        new if isinstance(new, tuple) else (new,))
        differ = max(int((x != y).sum()) for x, y in pairs_out)
        if differ:
            print(f"{label}: the two checkouts' walkers differ on {differ} rays", flush=True)
            fails += 1
            continue
        times = []
        for csrc in (parent, change, change, parent):
            c = use(csrc)
            fn(c)
            times.append(chip_smoke.cuda_time(lambda: fn(c), reps))
        counts_parent = torch.zeros((nb, 3), dtype=torch.int64, device=dev)
        fn(use(parent), counts=counts_parent)
        c = use(change)
        prof = torch.zeros((nb, len(woop.PROF_FIELDS)), dtype=torch.int64, device=dev)
        fn(c, counts=prof)
        rec = dict(zip(woop.PROF_FIELDS, (int(x) for x in prof.sum(0))))
        shares = {k: rec[k] / max(rec["total"], 1) for k in woop.PROF_FIELDS[:5]}
        lane_use = rec["pairs"] / 32 / max(rec["warp_pairs"], 1)
        # K1 (K2) on the same rays, the list (K5 + row sort), both with the
        # change's kernels, in turns with the walker
        ref = (lambda: woop.woop_any(rays, w, lo, hi)) if anyhit else (
            lambda: woop.woop_nearest(rays, w, lo, hi))
        ref_counts = torch.zeros(nb, dtype=torch.int64, device=dev)
        (woop.woop_any if anyhit else woop.woop_nearest)(rays, w, lo, hi, counts=ref_counts)
        make_list = lambda: woop.visit_list(rays, blo, bhi)
        walk = lambda: fn(c)
        turns = [chip_smoke.cuda_time(f, reps) for f in (make_list, ref, ref, make_list)]
        pairs = {"parent": int(counts_parent[:, 0].sum()), "change": rec["pairs"],
                 "K2" if anyhit else "K1": int(ref_counts.sum())}
        nbytes = (n * 32 + (n if anyhit else 8 * n) + nb * lst[0].shape[1] * 8
                  + (w.shape[0] // 3) * 48 + blo.shape[0] * 24)
        per_pair = chip_smoke.OPS_ANY if anyhit else chip_smoke.OPS_NEAREST
        own, by = chip_smoke.bound_ms(rec["pairs"] * per_pair, nbytes)
        fewest, _ = chip_smoke.bound_ms(min(pairs.values()) * per_pair, nbytes)
        p, ch = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        print(f"{label} [{smi}]: parent {times[0]:.4f} / {times[3]:.4f} ms, change "
              f"{times[1]:.4f} / {times[2]:.4f} ms, change / parent {ch / p:.4f}; list (K5 + "
              f"sort) {turns[0]:.4f} / {turns[3]:.4f} ms, {'K2' if anyhit else 'K1'} "
              f"{turns[1]:.4f} / {turns[2]:.4f} ms; pairs {pairs}; bound {own:.4f} ms at the "
              f"change's pairs ({by}), {fewest:.4f} at the fewest; change: cycle shares "
              + ", ".join(f"{k} {v:.4f}" for k, v in shares.items())
              + f", lane use {lane_use:.4f}, tile visits {rec['visits']}, compacted "
              f"{rec['compact_visits']}; parent: tile visits {int(counts_parent[:, 1].sum())}, "
              f"compacted {int(counts_parent[:, 2].sum())}; outputs equal", flush=True)
        if name == "bounce_target P=8 compact=32":
            # the compaction's lane limit, in turns: compact 32, 96, 128
            lim = [32, 96, 128]
            ms = {k: [] for k in lim}
            for k in lim + lim[::-1]:
                fn(c, compact=k)
                ms[k].append(chip_smoke.cuda_time(lambda: fn(c, compact=k), reps))
            print(f"city1600 K7 {name} compaction A/B [{smi}]: " + ", ".join(
                f"compact {k} ({woop.compact_lanes(k)} lanes) {v[0]:.4f} / {v[1]:.4f} ms"
                for k, v in ms.items()), flush=True)
    return fails


def keys_ab(dev, parent, change, reps, smi) -> None:
    """K4, K5 and the visit list of the two checkouts on city(1600, 7)'s
    1080p rays and on chip_smoke's edge-case boxes: bit-equal, then timed
    in turns; K4 with the change's slab counts and its bounds."""
    _, accel, _, pops = chip_smoke.city1600(dev)
    k1 = lambda name: woop.k1_inputs(accel, *pops[name])
    bounce, (target, _, lo, hi) = k1("bounce")[0], k1("bounce_target")
    nlo, nhi = woop.node_bounds(lo, hi, 8)
    clo, chi = accel.cluster_lo, accel.cluster_hi
    erng = np.random.default_rng(12)
    edge = chip_smoke.edge_rays(erng, device=dev)
    elo, ehi = chip_smoke.edge_boxes(erng, 100, device=dev)
    flo, fhi = chip_smoke.edge_boxes(erng, 100, few_empty=True, device=dev)
    k4 = lambda rays, a, b: lambda c: woop.target_keys(rays, a, b) if c["keys"] else older_keys(
        rays, a, b)
    k5 = lambda rays, a, b, slack: lambda c: woop.te_union(rays, a, b, slack=slack)
    lst = lambda rays, a, b: lambda c: visit_list_of(c, rays, a, b)
    runs = [("K4 bounce (pixel order)", k4(bounce, clo, chi), (bounce, clo, chi)),
            ("K4 bounce_target", k4(target, clo, chi), (target, clo, chi)),
            ("K4 edge boxes", k4(edge, flo, fhi), None),
            ("K5 walker mode bounce_target clusters", k5(target, lo, hi, True), None),
            ("K5 walker mode bounce_target nodes8", k5(target, nlo, nhi, True), None),
            ("K5 JAX mode bounce clusters", k5(bounce, clo, chi, False), None),
            ("K5 edge boxes JAX mode", k5(edge, elo, ehi, False), None),
            ("K5 edge boxes walker mode", k5(edge, elo, ehi, True), None),
            ("list bounce_target clusters", lst(target, lo, hi), None),
            ("list bounce_target nodes8", lst(target, nlo, nhi), None),
            ("list edge boxes", lst(edge, elo, ehi), None)]
    for name, fn, count_args in runs:
        base = fn(use(parent))
        same(name, fn(use(change)), base)
        times = []
        for csrc in (parent, change, change, parent):
            c = use(csrc)
            fn(c)
            times.append(chip_smoke.cuda_time(lambda: fn(c), reps))
        p, ch = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        extra = ""
        if count_args is not None:
            rays, a, b = count_args
            n, nc = rays.shape[1], a.shape[0]
            counts = torch.zeros((n // woop.RAY_BLOCK, 3), dtype=torch.int64, device=dev)
            use(change)
            woop.target_keys(rays, a, b, counts=counts)
            work = dict(zip(woop.KEY_COUNTS, (int(x) for x in counts.sum(0))))
            tested = work["slabs"] + work["node_slabs"]
            bound = lambda ops: chip_smoke.bound_ms(ops, n * 36 + nc * 24)[0]
            extra = (f"; change's work {work} ({tested / (n * nc):.4f} of rays x boxes); bound "
                     f"{bound(chip_smoke.OPS_SLAB_CHOSEN * tested):.4f} ms at 18 operations a "
                     f"slab it computed; over every ray x box "
                     f"{bound(chip_smoke.OPS_SLAB_CHOSEN * n * nc):.4f} at 18, "
                     f"{bound(chip_smoke.OPS_SLAB * n * nc):.4f} at the JAX slab's 24")
        print(f"city1600 {name} [{smi}]: parent {times[0]:.4f} / {times[3]:.4f} ms, change "
              f"{times[1]:.4f} / {times[2]:.4f} ms, change / parent {ch / p:.4f}; outputs "
              f"bit-equal{extra}", flush=True)
    use(change)


def device_ms(fn) -> float:
    """The device time of the kernels and copies ``fn()`` launches
    (``torch.profiler``), in ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0)
    return sum(dev_us(e) for e in prof.key_averages() if e.device_type.name != "CPU") / 1e3


def frames_ab(dev, parent, change, smi, frames=3) -> None:
    """city(1600, 7)'s 1080p frames under the schedules that launch K4 and
    the visit list (PT with the target key, PT and MCPG under (True, 8,
    32)), rendered with the kernels of the two checkouts in turns (parent,
    change, change, parent; ``frames`` frames a turn on the host clock,
    then one under the profiler for its device time), one state carried
    through the turns."""
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig

    bundle, accel, config, _ = chip_smoke.city1600(dev)
    own = (woop.target_keys, woop.visit_list)

    def switch(csrc):
        c = use(csrc)
        woop.target_keys, woop.visit_list = own if c["keys"] else (
            lambda rays, lo, hi, counts=None: older_keys(rays, lo, hi),
            lambda rays, lo, hi: visit_list_of(c, rays, lo, hi))

    S = woop.TraceSchedule
    try:
        for path, integrator, sched in (("pt target key", "pt", S(target_key=True)),
                                        ("pt (True, 8, 32)", "pt", S(True, 8, 32)),
                                        ("mcpg (True, 8, 32)", "mcpg", S(True, 8, 32))):
            cfg = config._replace(integrator=integrator)
            mcfg = MCPGConfig() if integrator == "mcpg" else None
            state = [init_state(cfg, mcfg, device=dev)]
            frame = [0]

            def step():
                state[0], _ = render_frame(accel, bundle.atlas,
                                           bundle.uniforms._replace(frame=frame[0]), cfg,
                                           state[0], mcfg, schedule=sched)
                frame[0] += 1

            switch(change)
            for _ in range(4):
                step()
            host, device = {}, {}
            for label, csrc in (("parent", parent), ("change", change), ("change", change),
                                ("parent", parent)):
                switch(csrc)
                step()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(frames):
                    step()
                torch.cuda.synchronize()
                host.setdefault(label, []).append((time.perf_counter() - t0) * 1e3 / frames)
                device.setdefault(label, []).append(device_ms(step))
            fmt = lambda d, k: " / ".join(f"{x:.2f}" for x in d[k])
            print(f"city1600 frame {path} 1920x1080 [{smi}]: host ms/frame parent "
                  f"{fmt(host, 'parent')}, change {fmt(host, 'change')}; device ms/frame parent "
                  f"{fmt(device, 'parent')}, change {fmt(device, 'change')} (turns parent, "
                  f"change, change, parent)", flush=True)
    finally:
        woop.target_keys, woop.visit_list = own
        use(change)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="the other checkout's root")
    ap.add_argument("--map", action="store_true", help="add K3, K2's proxy and K8 on the map")
    ap.add_argument("--reps", type=int, default=10, help="launches a timed turn")
    ap.add_argument("--only", default="", help="kernels to compare, e.g. K2,K8 (default all)")
    ap.add_argument("--frames", action="store_true",
                    help="add city(1600)'s frames under the K4/K5 schedules, in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_trace_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    change = kernels.CSRC_DIR
    parent = os.path.join(os.path.abspath(args.parent), "merian_quake_tpu_torch", "csrc")
    for label, csrc in (("parent", parent), ("change", change)):
        use(csrc)
        kernels.build_libraries(*SOURCES)
        for name in SOURCES[:-1]:
            for line in spills(name):
                print(f"ptxas {label} {name} {line}", flush=True)

    only = [k for k in args.only.split(",") if k]
    fails = 0
    if not only or "K4" in only or "K5" in only:
        keys_ab(dev, parent, change, args.reps, smi)
    if args.frames:
        frames_ab(dev, parent, change, smi)
    if not only or "K6" in only or "K7" in only:
        fails += list_ab(dev, parent, change, args.reps, smi)
    runs = []
    if not only or set(only) - {"K4", "K5", "K6", "K7"}:
        runs = cases(dev, {}, True) + court_cases(dev)
        if args.map:
            runs += cases(dev, chip_smoke.MAP, False)
    for name, fn in runs:
        if only and not any(f" {k} " in name for k in only):
            continue
        base = fn(use(parent))
        same(name, fn(use(change)), base)
        reps = 3 if " K8 " in name else args.reps
        times = []
        for csrc in (parent, change, change, parent):
            c = use(csrc)
            fn(c)
            times.append(chip_smoke.cuda_time(lambda: fn(c), reps))
        p = (times[0] + times[3]) / 2
        ch = (times[1] + times[2]) / 2
        print(f"{name} [{smi}]: parent {times[0]:.4f} / {times[3]:.4f} ms, change "
              f"{times[1]:.4f} / {times[2]:.4f} ms, change / parent {ch / p:.4f}; "
              f"outputs bit-equal", flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
