"""The control of the comparison that decides ``correct``: the plain
reference with its hits computed in bfloat16, put in the program's place.

    python3 -m quakebench.control --workload <cell> --seed <n> --seconds <s>

runs the cell as ``quakebench.run`` does (a short window is enough), then
judges the reference's own frame and the bfloat16 reference's frame from
the same start, and prints one JSON line: the program's numbers
(``check``) and the control's (``control``), each beside its limit. A
sound comparison passes the first and fails the second. The benchmark's
runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys

from quakebench import run, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("quakebench.control: no CUDA device", file=sys.stderr)
        return 2
    out = run.run_cell(spec.load_benchmark(), args.workload, args.seed, args.seconds, False,
                       control=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "check": out["check"],
                      "control": out["control"], "worst_leaf": out["worst_leaf"],
                      "check_s": out["check_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
