#!/usr/bin/env python3
"""The JAX package's certification numbers at the CPU tests' arguments,
jitted and op by op, for the port's certification tests to hold to.

    JAX_PLATFORMS=cpu python3 scripts/certify_jax_values.py [case ...] [--images DIR]

Cases (tests/test_torch_certify.py and test_torch_certify_court.py use
the same arguments; ``merian_quake_tpu.utils.certify.certify_presets``):

- ``config1_8`` / ``config1_2``: config1 at ``scale=0.08`` (48×24), 8 /
  2 frames, 64 truth frames, 4 truth runs;
- ``config6``: config6 at ``scale=0.1`` (64×32), 12 frames, 64 truth
  frames, 2 truth runs;
- ``config5``: config5 at ``scale=0.05`` (96×48), 16 frames, 32 truth
  frames, 2 truth runs (MCPG + volume; the truth is the unguided MCPG);
- ``config3_skip``: config3 (ReSTIR) at ``scale=0.05`` (96×48), 20
  frames measured from frame 16 on (``steady_skip=16``), 16 truth
  frames, 1 truth run.

Each case runs twice: as the JAX package runs it (its ``render_frame`` is
jitted) and op by op (``jax.disable_jit``). XLA contracts multiply-adds
when it compiles and not op by op, so the two runs' paths part where an
ulp decides one; the difference between their relMSEs is the JAX
package's own spread, the yardstick of a port-against-JAX bound. Prints
one JSON line a case. The JAX package is never edited, so its values
cannot go stale. Takes minutes (config5 op by op the longest).

The images behind the numbers: each image that ``certify_presets``
renders (its ``_run`` calls in order: the truth runs, the candidate, the
equal-budget reference) is recorded in both runs. The row's
``pixels_apart`` gives, for each image, the share of pixels whose
largest channel differs between the jitted and the op-by-op image by
more than ``PIX_REL`` relative; with ``--images DIR``
the op-by-op images are written to ``DIR/certify_<case>_jax.npz``
(tests/data/certify_config5_jax.npz is ``config5``'s).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = {
    "config1_8": dict(names=["config1"], scale=0.08, frames=8, ref_frames=64),
    "config1_2": dict(names=["config1"], scale=0.08, frames=2, ref_frames=64),
    "config6": dict(names=["config6"], scale=0.1, frames=12, ref_frames=64, ref_runs=2),
    "config5": dict(names=["config5"], scale=0.05, frames=16, ref_frames=32, ref_runs=2),
    "config3_skip": dict(names=["config3"], scale=0.05, frames=20, ref_frames=16, ref_runs=1,
                         steady_skip=16),
}
PIX_REL = 1e-3
KEYS = ("resolution", "relmse", "relmse_pt_equal_budget", "ratio_vs_pt", "relmse_trimmed",
        "relmse_trimmed_pt", "ratio_trimmed_vs_pt")


def pixels_apart(a, b, rel=PIX_REL) -> float:
    """Share of pixels whose largest channel differs by more than ``rel``
    relative to ``b`` (1e-3 absolute near black)."""
    d = np.abs(np.asarray(a, np.float64) - b) / (np.abs(np.asarray(b, np.float64)) + 1e-3)
    return float((d.max(-1) > rel).mean())


def image_names(kw) -> list:
    """The names of ``certify_presets``' ``_run`` images, in call order
    (an MCPG or ReSTIR preset without a skip or convergence series)."""
    return ([f"truth_run_{r + 1}" for r in range(kw.get("ref_runs", 4))]
            + ["candidate", "reference"])


def main(argv) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from merian_quake_tpu.utils import certify

    images_dir = None
    if "--images" in argv:
        i = argv.index("--images")
        images_dir, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    plain_run = certify._run
    for case in argv or list(CASES):
        kw = CASES[case]
        row = {"case": case, "args": kw}
        images = {}
        for mode in ("jit", "op_by_op"):
            got = images[mode] = []

            def spy(*a, **k):
                out = plain_run(*a, **k)
                got.append(np.asarray(out[0] if isinstance(out, tuple) else out, np.float32))
                return out

            certify._run = spy
            t0 = time.perf_counter()
            try:
                if mode == "jit":
                    r = certify.certify_presets(**kw)[kw["names"][0]]
                else:
                    with jax.disable_jit():
                        r = certify.certify_presets(**kw)[kw["names"][0]]
            finally:
                certify._run = plain_run
            row[mode] = {k: r[k] for k in KEYS}
            row[mode]["seconds"] = time.perf_counter() - t0
        j, o = row["jit"], row["op_by_op"]
        row["spread_rel"] = {k: abs(j[k] - o[k]) / abs(j[k]) for k in KEYS[1:]}
        names = image_names(kw)
        if len(names) == len(images["jit"]):
            row["pixels_apart"] = {n: pixels_apart(a, b) for n, a, b
                                   in zip(names, images["jit"], images["op_by_op"])}
            if images_dir:
                np.savez_compressed(os.path.join(images_dir, f"certify_{case}_jax.npz"),
                                    **dict(zip(names, images["op_by_op"])))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
