#!/usr/bin/env python3
"""relMSE certification of the tracked presets with the PyTorch port.

    python3 scripts/certify_torch.py [--presets config1 ...] [--scale 0.25]
        [--frames 64] [--ref-frames 256] [--ref-runs 4] [--realtime-frames 8]
        [--steady-skip 16] [--out CERT_relmse_torch.json]
        [--convergence-dir DIR] [--device cuda] [--equal-time]
        [--row-suffix SUFFIX]

The port's counterpart of the JAX package's ``cli certify`` (same
arguments and defaults, plus ``--device``, ``--steady-skip`` and
``--equal-time``): runs
``merian_quake_tpu_torch.utils.certify.certify_presets`` one preset at a
time and merges each row into ``--out`` as soon as it is done (a file
that exists keeps its other rows), so a run cut short keeps the rows it
finished. Each row also gets the seconds it took and, on the card, the
card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them. ``--steady-skip 0`` is the real-time regime of a reuse preset
(ReSTIR, SSMM: ``--realtime-frames`` frames, no steady window): its rows
are named ``<preset>_realtime`` and carry CERT_relmse.json's note for
that regime. ``--equal-time`` adds each integrator's ms/frame and the
reference's relMSE at equal time; every run goes through one compiled
frame (on the card one CUDA graph a run), so those are captured frames'
times. ``--row-suffix`` appends to each row's name (a run at another
scale beside the named-size rows: ``--presets config3 --scale 0.5
--row-suffix _960x536``, the TPU row's size).

On the card, every preset at its named resolution (about 18 minutes on
an H100): ``python3 scripts/certify_torch.py --scale 1.0 --equal-time
--convergence-dir docs/convergence_torch``. On the CPU:
``python3 scripts/certify_torch.py --presets config1 --scale 0.08
--frames 8 --ref-frames 64 --device cpu --out /tmp/cert.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


REALTIME_NOTE = (
    "real-time regime: {realtime_frames}-frame budget, no steady window — the low-sample regime "
    "temporal reuse exists for; see the plain {name} row for the {frames}-frame "
    "steady-state measurement"
)


def card_line(device) -> str | None:
    """The card's name and power limit, or None off the card."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--presets", nargs="*", default=None)
    p.add_argument("--scale", type=float, default=0.25)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--ref-frames", type=int, default=256)
    p.add_argument("--ref-runs", type=int, default=4,
                   help="independent truth runs averaged (combine_images.py workflow)")
    p.add_argument("--realtime-frames", type=int, default=8,
                   help="candidate budget for the real-time reuse estimators (ReSTIR/SSMM)")
    p.add_argument("--steady-skip", type=int, default=16)
    p.add_argument("--out", default="CERT_relmse_torch.json")
    p.add_argument("--convergence-dir", default=None,
                   help="also write per-preset power-of-2 relMSE convergence CSVs")
    p.add_argument("--device", default="cuda")
    p.add_argument("--equal-time", action="store_true",
                   help="add ms/frame and the reference's relMSE at equal time")
    p.add_argument("--row-suffix", default="",
                   help="appended to each row's name in --out")
    args = p.parse_args(argv)

    import torch

    from merian_quake_tpu_torch.presets import PRESETS
    from merian_quake_tpu_torch.utils.certify import certify_presets

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("certify_torch: no CUDA device (pass --device cpu for the CPU)")
    card = card_line(args.device)
    rows = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f)
    for name in args.presets or list(PRESETS):
        t0 = time.perf_counter()
        row = certify_presets(
            names=[name], scale=args.scale, frames=args.frames,
            ref_frames=args.ref_frames, ref_runs=args.ref_runs,
            realtime_frames=args.realtime_frames,
            convergence_dir=args.convergence_dir, steady_skip=args.steady_skip,
            device=args.device, equal_time=args.equal_time,
        )[name]
        row.update(scale=args.scale, seconds=time.perf_counter() - t0, device=card or args.device)
        key = name
        if args.steady_skip == 0 and PRESETS[name].config.integrator in ("restir", "ssmm"):
            key = name + "_realtime"
            row["note"] = REALTIME_NOTE.format(
                name=name, realtime_frames=args.realtime_frames, frames=args.frames)
        key += args.row_suffix
        rows[key] = row
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
        print(json.dumps({key: row}), flush=True)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
