"""``python3 -m chip_smoke [--phase N [N ...]]``: every phase, or phase 1
and the phases named."""
import argparse
import sys

from .registry import PHASES, run

if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python3 -m chip_smoke",
                                     description="The port's check on one CUDA card.")
    parser.add_argument("--phase", type=int, nargs="+", metavar="N",
                        choices=[n for n, _ in PHASES],
                        help="run phase 1, then only these (with the fixtures they read)")
    sys.exit(run(parser.parse_args().phase))
