#!/usr/bin/env python3
"""K1, K2 and K3 of this checkout against the same kernels of another
checkout, on one GPU: equal results, and their times in turns.

    python3 scripts/ab_trace_kernels.py --parent DIR [--map] [--reps 10]

DIR is another checkout of the repo, for example the parent commit
unpacked with ``git archive``. The kernel sources of both checkouts are
built with nvcc for sm_90a into this checkout's ``_build/`` (a library's
name carries a hash of its sources, so the two builds never collide) and
launched on the same inputs. A checkout whose K1 and K3 are the walk of
``csrc/woop_walk.cuh`` is launched through this checkout's wrappers (which
read the node sizes from each library); an older one (a
CTA of 128 rays walking the clusters, entry points that take ``woop_w``
and the cluster bounds) through this script's own calls with that
argument list. The inputs: city's
(16,640 triangles) 1080p primary rays and sorted first-bounce rays (K1,
and K3 forced on the same table), and the ReSTIR shade pass's shadow rays
(K2 on the shadow table warm-started by the proxy pre-pass, as the frame
launches it, and K3's any-hit form). With ``--map`` the map scene
(``city(28000, 11)``, 281,536 triangles) adds its primary, bounce and
shadow rays through K3. Each kernel's output must equal the other
checkout's bit for bit. Times are CUDA-event means over ``--reps``
launches, taken in the turns parent, change, change, parent. Prints one
line a measurement with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (ray populations, cuda_time)
from merian_quake_tpu_torch import kernels  # noqa: E402
from merian_quake_tpu_torch.accel import build_accel, woop  # noqa: E402
from merian_quake_tpu_torch.accel.build import scene_features  # noqa: E402
from merian_quake_tpu_torch.models.procedural import city  # noqa: E402
from merian_quake_tpu_torch.models.types import RenderConfig  # noqa: E402

SOURCES = ("woop_nearest", "woop_any", "woop_stream")


def use(csrc: str) -> bool:
    """Have every wrapper launch the kernels built from ``csrc``; returns
    whether its K1 and K3 are the walk (else the older argument list)."""
    kernels.CSRC_DIR = csrc
    kernels.load_library.cache_clear()
    return os.path.exists(os.path.join(csrc, "woop_walk.cuh"))


def older(name, rays, w, lo, hi, occ=None, anyhit=False):
    """K1 or K3 of a checkout from before the walk: (rays, n_pad, woop_w,
    lo, hi, nc, block, out0, out1, counts, stream)."""
    n, dev = rays.shape[1], rays.device
    if anyhit:
        out = torch.empty(n, dtype=torch.bool, device=dev)
        outs = (None if occ is None else occ.data_ptr(), out.data_ptr())
    else:
        out = (torch.empty(n, dtype=torch.float32, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev))
        outs = (out[0].data_ptr(), out[1].data_ptr())
    entry = "mq_woop_stream_any" if anyhit else None
    woop._call(woop._kernel_lib(name, entry, woop._WOOP_ARGS), dev, rays.data_ptr(), n,
               w.data_ptr(), lo.data_ptr(), hi.data_ptr(), lo.shape[0], woop.RAY_BLOCK, *outs, None)
    return out


def same(name, a, b) -> None:
    torch.cuda.synchronize()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: the two checkouts' kernels differ")


def cases(dev, scene_kw, with_k1_k2):
    """(name, fn) pairs on one scene's 1080p rays; fn(walk) launches the
    kernel of the checkout in use (``walk``: what :func:`use` returned)."""
    bundle = city(**scene_kw, device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    config = RenderConfig(width=chip_smoke.W, height=chip_smoke.H, spp=chip_smoke.SPP,
                          max_path_length=chip_smoke.MPL, features=feats)
    n = chip_smoke.W * chip_smoke.H
    full = lambda v: torch.full((n,), v, device=dev)
    po, pd = chip_smoke.primary_rays(bundle, accel, dev)
    bo, bd, bt = chip_smoke.bounce_rays(bundle, accel, config, dev)
    perm = woop.sort_perm(accel, bo, bd, bt)
    bo, bd, bt = bo[perm].contiguous(), bd[perm].contiguous(), bt[perm].contiguous()
    so, sd, st = chip_smoke.shade_rays(bundle, accel, config, dev)
    prim = woop.k1_inputs(accel, po, pd, full(0.0), full(1e4))
    boun = woop.k1_inputs(accel, bo, bd, full(0.0), bt)
    rays, proxy, shadow = woop.k2_inputs(accel, so, sd, full(1e-3), st)
    pre = woop.woop_any(rays, *proxy)
    tag = "map" if scene_kw else "city"
    k1 = lambda a: lambda walk: woop.woop_nearest(*a) if walk else older("woop_nearest", *a)
    k3 = lambda a: lambda walk: woop.woop_stream(*a) if walk else older("woop_stream", *a)
    out = []
    if with_k1_k2:
        out += [(f"{tag} K1 primary", k1(prim)), (f"{tag} K1 bounce", k1(boun)),
                (f"{tag} K2 shadow after proxy", lambda walk: woop.woop_any(rays, *shadow, pre))]
    out += [(f"{tag} K3 primary", k3(prim)), (f"{tag} K3 bounce", k3(boun)),
            (f"{tag} K3 shadow after proxy",
             lambda walk: woop.woop_stream(rays, *shadow, anyhit=True, occluded_in=pre) if walk
             else older("woop_stream", rays, *shadow, occ=pre, anyhit=True))]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="the other checkout's root")
    ap.add_argument("--map", action="store_true", help="add K3 on the map scene")
    ap.add_argument("--reps", type=int, default=10, help="launches a timed turn")
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
    for csrc in (parent, change):
        use(csrc)
        kernels.build_libraries(*SOURCES)

    runs = cases(dev, {}, True)
    if args.map:
        runs += cases(dev, chip_smoke.MAP, False)
    for name, fn in runs:
        base = fn(use(parent))
        same(name, fn(use(change)), base)
        times = []
        for csrc in (parent, change, change, parent):
            walk = use(csrc)
            fn(walk)
            times.append(chip_smoke.cuda_time(lambda: fn(walk), args.reps))
        p = (times[0] + times[3]) / 2
        c = (times[1] + times[2]) / 2
        print(f"{name} [{smi}]: parent {times[0]:.4f} / {times[3]:.4f} ms, change "
              f"{times[1]:.4f} / {times[2]:.4f} ms, change / parent {c / p:.4f}; "
              f"outputs bit-equal", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
