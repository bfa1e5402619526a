#!/usr/bin/env python3
"""The loops of a hand-written kernel's machine code: what a kernel issues
in its inner loop, read from the SASS that nvcc built for sm_90a.

    python3 scripts/sass_loops_torch.py NAME [--csrc DIR] [--kernel SUBSTR] [--out DIR]

Builds ``csrc/NAME.cu`` (of this checkout, or of the checkout whose
``csrc/`` is DIR) as ``merian_quake_tpu_torch/kernels.py`` builds it,
disassembles the library with ``cuobjdump -sass`` and, for each kernel
whose name contains SUBSTR, finds every loop (a branch back to a lower
address) and prints a line a loop: its address range, its instructions
and their count by opcode (FADD, FMUL, FSETP, MUFU, LDS, BRA, ...). The
whole disassembly goes to ``DIR/sass_NAME.txt`` (``--out``, default
``profiling``). Per (ray, triangle) pair = a loop's count divided by
the pairs one trip of it tests (the source's unroll times rays a
thread), which the reader takes from the source.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from merian_quake_tpu_torch import kernels  # noqa: E402

LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(found):
        raise SystemExit("cuobjdump not found")
    return found


def functions(sass: str):
    """(name, [(address, opcode, operands)]) of each function."""
    out, name, body = [], None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                out.append((name, body))
            name, body = m.group(1), []
            continue
        m = LINE.search(line)
        if name and m:
            body.append((int(m.group(1), 16), m.group(3), m.group(4).strip()))
    if name:
        out.append((name, body))
    return out


def loops(body):
    """(first, last) address of each backward branch's loop."""
    found = []
    for addr, op, args in body:
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", args)
            if m and int(m.group(1), 16) < addr:
                found.append((int(m.group(1), 16), addr))
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("name", help="the source csrc/NAME.cu")
    ap.add_argument("--csrc", default=None, help="another checkout's csrc/ directory")
    ap.add_argument("--kernel", default="", help="only kernels whose name holds this")
    ap.add_argument("--out", default=os.path.join(ROOT, "profiling"),
                    help="where the disassembly goes")
    args = ap.parse_args()
    if args.csrc:
        kernels.CSRC_DIR = os.path.abspath(args.csrc)
    kernels.build_libraries(args.name)
    lib = kernels.library_path(args.name)
    sass = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"sass_{args.name}.txt"), "w") as f:
        f.write(sass)
    with open(lib + ".log") as f:
        print(" | ".join(line.strip() for line in f if "ptxas info" in line
                         and ("Used" in line or "spill" in line)))
    for name, body in functions(sass):
        if args.kernel not in name:
            continue
        print(f"{name}: {len(body)} instructions")
        for first, last in loops(body):
            ops = [op for addr, op, _ in body if first <= addr <= last]
            hist = collections.Counter(op.split(".")[0] for op in ops)
            print(f"  loop 0x{first:x}-0x{last:x}: {len(ops)} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in hist.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
