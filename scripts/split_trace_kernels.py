#!/usr/bin/env python3
"""Where K1's, K2's and K3's cycles go, on one GPU: the split by phase of
their profile instances on the frames' own ray populations.

    python3 scripts/split_trace_kernels.py [--map]

Builds this checkout's kernels with nvcc for sm_90a, makes city's (16,640
triangles) 1080p primary rays and sorted first-bounce rays, launches K1's
profile instance on them (``counts=`` int64[n / 128, 10], see
``woop.PROF_FIELDS``) and prints, a line a population: the cycles summed
over all warps and their shares in the node list, the gates that look for
the next tile, a tile's issue and second gate, tile waits and pair loops
(the first designs: the gates and barriers of skipped and of visited
entries); the pairs tested; the
warp-issued pairs; the lane use; and the CTAs that fit an SM. With
``--map`` the map scene (``city(28000, 11)``, 281,536 triangles) adds
K3's split on its primary, bounce and shadow rays (the shadow sweep
warm-started by the proxy pre-pass, as the frame launches it). The
profile instance reads clock64 at every phase boundary, so its own time
is not the frame kernel's: only the shares and counts are to be read.

The first designs of K1 and K3 (one CTA of 128 rays walking the clusters,
the commit before the walk of ``csrc/woop_walk.cuh``) were read with this
script too, on a copy of that commit whose kernels carried the same
profile; PERF.md has that table.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import common, fixtures  # noqa: E402  (ray populations, trace_split)
from merian_quake_tpu_torch import kernels  # noqa: E402
from merian_quake_tpu_torch.accel import build_accel, woop  # noqa: E402
from merian_quake_tpu_torch.accel.build import scene_features  # noqa: E402
from merian_quake_tpu_torch.models.procedural import city  # noqa: E402
from merian_quake_tpu_torch.models.types import RenderConfig  # noqa: E402


def populations(dev, scene_kw):
    """(accel, primary args, sorted bounce args, (rays, shadow, pre)) of
    one scene's 1080p rays."""
    bundle = city(**scene_kw, device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    config = RenderConfig(width=common.W, height=common.H, spp=common.SPP,
                          max_path_length=common.MPL, features=feats)
    n = common.W * common.H
    full = lambda v: torch.full((n,), v, device=dev)
    po, pd = fixtures.primary_rays(bundle, accel, dev)
    bo, bd, bt = fixtures.bounce_rays(bundle, accel, config, dev)
    perm = woop.sort_perm(accel, bo, bd, bt)
    bo, bd, bt = bo[perm].contiguous(), bd[perm].contiguous(), bt[perm].contiguous()
    so, sd, st = fixtures.shade_rays(bundle, accel, config, dev)
    rays, proxy, shadow = woop.k2_inputs(accel, so, sd, full(1e-3), st)
    return (accel, woop.k1_inputs(accel, po, pd, full(0.0), full(1e4)),
            woop.k1_inputs(accel, bo, bd, full(0.0), bt),
            (rays, shadow, woop.woop_any(rays, *proxy)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--map", action="store_true", help="add K3 on the map scene")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("split_trace_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kernels.build_libraries("woop_nearest", "woop_any", "woop_stream")
    for name in ("woop_nearest", "woop_any", "woop_stream"):
        with open(kernels.library_path(name) + ".log") as f:
            print(name, " | ".join(line.strip() for line in f if "ptxas info" in line
                                   and ("Used" in line or "spill" in line)), flush=True)

    accel, prim, boun, (rays, shadow, pre) = populations(dev, {})
    nc = accel.cluster_lo.shape[0]
    print(f"city: {nc} clusters; CTAs an SM: K1 {woop.ctas_per_sm('woop_nearest', nc)}, "
          f"K2 {woop.ctas_per_sm('woop_any', nc)}, K3 {woop.ctas_per_sm('woop_stream', nc)}",
          flush=True)
    common.trace_split(0, "city primary K1", woop.woop_nearest, prim, smi)
    common.trace_split(0, "city bounce K1", woop.woop_nearest, boun, smi)
    common.trace_split(0, "city shadow K2", woop.woop_any, (rays, *shadow), smi)
    common.trace_split(0, "city primary K3", woop.woop_stream, prim, smi)
    common.trace_split(0, "city bounce K3", woop.woop_stream, boun, smi)
    if args.map:
        accel, prim, boun, (rays, shadow, pre) = populations(dev, fixtures.MAP)
        nc = accel.cluster_lo.shape[0]
        print(f"map: {nc} clusters; CTAs an SM: K3 {woop.ctas_per_sm('woop_stream', nc)}",
              flush=True)
        common.trace_split(0, "map primary K3", woop.woop_stream, prim, smi)
        common.trace_split(0, "map bounce K3", woop.woop_stream, boun, smi)
        common.trace_split(0, "map shadow K3 any-hit after proxy", woop.woop_stream,
                               (rays, *shadow), smi, anyhit=True, occluded_in=pre)
        for name, fn in (("map K3 primary", lambda: woop.woop_stream(*prim)),
                         ("map K3 bounce", lambda: woop.woop_stream(*boun))):
            fn()
            print(f"{name} [{smi}]: {common.cuda_time(fn, 5):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
