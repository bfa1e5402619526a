#!/usr/bin/env python3
"""Row-slab frames across the cards of one machine, one card a rank.

    python3 scripts/multichip_torch.py [--ranks N] [--backend nccl|gloo] [--frames F] [--out DIR]

Runs chip_smoke's phase 37 with N ranks (default 4, NCCL), rank r on
card r: ``dryrun_multichip(N)``, then the sharded city frames at
1920x1080, 2 spp, max path length 3 (F frames each, default 4: MCPG at
``MCPGConfig()`` and at N times its queue capacities, ReSTIR, denoised
PT), each rank's launches, ms/frame and gathered bytes, held against the
single-device ``frame_core`` on card 0 (whose ms/frame it prints beside).
Builds the kernels and the native accel builder first, prints every
card's name and power limit, writes its JSON record to
``DIR/multichip_torch.json`` and prints it as its last line. Fails
without N cards.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"multichip_torch: needs {args.ranks} CUDA devices, has "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from chip_smoke.native import phase37
    from merian_quake_tpu_torch import kernels
    from merian_quake_tpu_torch.utils import native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    t0 = time.perf_counter()
    kernels.build_libraries(*kernels.KERNELS)
    native.build_library()
    print(f"kernels and native builder built in {time.perf_counter() - t0:.1f} s", flush=True)
    paths, stats = phase37(torch.device("cuda", 0), smi[0], n=args.ranks, backend=args.backend,
                           frames=args.frames)
    record = {"cards": smi, "ranks": args.ranks, "backend": args.backend,
              "torch": torch.__version__, "launches": paths, "readings": stats}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "multichip_torch.json"), "w") as f:
        json.dump(record, f)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
