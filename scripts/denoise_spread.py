#!/usr/bin/env python3
"""The JAX package's own spread on denoised frames, beside the port's.

    JAX_PLATFORMS=cpu python3 scripts/denoise_spread.py pt|ssmm|volume [--frames 3]

Renders the same frames three ways on the CPU: the JAX package jitted
(its ``render_sequence``), the JAX package op by op (``jax.disable_jit``)
and the port (``render_sequence(..., device="cpu")``), and prints for
each output and each denoiser state the share of pixels within 1e-3, the
mean and the largest |Δ| of jitted against op-by-op, of port against
jitted and of port against op-by-op. XLA contracts multiply-adds when it
compiles and not op by op; PyTorch never does, so the port follows the
op-by-op run. The first column is the bound a port-against-jitted test
may hold to (tests/test_torch_denoise_slice.py).

Cases, all 64×36: ``pt`` cornell_box, 2 spp, max path length 3; ``ssmm``
cornell_box, 2 spp; ``volume`` the fogged court (``outdoor_court(0.002)``),
MCPG + ``VolumeConfig()``, 1 spp, max path length 3; each with
``denoise=True``. Takes minutes (the op-by-op run of the court about 35 s
a frame on one CPU core).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def agree(a, b) -> str:
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    d = np.abs(a - b)
    per_pixel = d.max(-1) if d.ndim == 3 else d
    return f"{(per_pixel <= 1e-3).mean():.5f} {d.mean():.3e} {d.max():.3e}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("case", choices=("pt", "ssmm", "volume"))
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from merian_quake_tpu.models import procedural as jp
    from merian_quake_tpu.models.types import RenderConfig as JConfig
    from merian_quake_tpu.render.mcpg import MCPGConfig as JMCPGConfig
    from merian_quake_tpu.render.mcpg.volume import VolumeConfig as JVolumeConfig
    from merian_quake_tpu.renderer import render_sequence as j_render_sequence
    from merian_quake_tpu_torch.models import procedural as tp
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    torch.set_num_threads(2)
    jm = tm = None
    if args.case == "pt":
        kw = dict(spp=2, max_path_length=3)
        jb, tb = jp.cornell_box, tp.cornell_box
    elif args.case == "ssmm":
        kw = dict(spp=2, integrator="ssmm")
        jb, tb = jp.cornell_box, tp.cornell_box
    else:
        kw = dict(spp=1, max_path_length=3, integrator="mcpg")
        jb = lambda: jp.outdoor_court(0.002)
        tb = lambda device: tp.outdoor_court(0.002, device=device)
        jm, tm = JMCPGConfig(volume=JVolumeConfig()), MCPGConfig(volume=VolumeConfig())
    kw.update(width=64, height=36, denoise=True)
    n = args.frames
    t0 = time.perf_counter()
    js, jo = j_render_sequence(jb(), JConfig(**kw), frames=n, mcpg_config=jm)
    jax.block_until_ready(jo["ldr"])
    t1 = time.perf_counter()
    with jax.disable_jit():
        ds, do = j_render_sequence(jb(), JConfig(**kw), frames=n, mcpg_config=jm)
    t2 = time.perf_counter()
    ts, to = render_sequence(tb(device="cpu"), RenderConfig(**kw), frames=n, mcpg_config=tm,
                             device="cpu")
    t3 = time.perf_counter()
    print(f"{args.case} 64x36 x{n} frames: jitted {t1 - t0:.1f} s, op by op {t2 - t1:.1f} s, "
          f"port {t3 - t2:.1f} s")
    print("output: jitted~op-by-op | port~jitted | port~op-by-op (share within 1e-3, mean |d|, "
          "max |d|)")
    for k in [k for k in ("ldr", "hdr", "irradiance", "volume") if k in jo]:
        print(f"{k}: {agree(jo[k], do[k])} | {agree(to[k], jo[k])} | {agree(to[k], do[k])}")
    for f in [f for f in ("svgf", "volume_svgf") if getattr(js, f) is not None]:
        for g in ("irr", "moments", "history_len"):
            j, d, t = (getattr(getattr(s, f), g) for s in (js, ds, ts))
            print(f"{f}.{g}: {agree(j, d)} | {agree(t, j)} | {agree(t, d)}")
    print(f"taa_prev: {agree(js.taa_prev, ds.taa_prev)} | {agree(ts.taa_prev, js.taa_prev)} | "
          f"{agree(ts.taa_prev, ds.taa_prev)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
