"""Run one cell of the benchmark once and print its result line.

    python3 -m quakebench.run --workload <config>.<mix> --seed <n> \\
        --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from this module's import to the first
timed frame): the imports, the scene and its tables, the frame state, the
compiled frame's first call (its warm-up and capture) and the mix's
settle frames. The window then runs whole frames until ``--seconds``
have passed: a frame runs from the start of its game step (a still
camera: its replay) to the ``torch.cuda.synchronize()`` after its
replay. ``--trace 1`` runs the profiler over the first TRACE_SECONDS of
frames instead and reports the per-layer metrics; ``--trace 0`` records
no span and runs no profiler.

After the window the peak device memory is read, the program renders
one frame more through the same compiled frame, its memory is freed and
the plain reference judges that frame (quakebench/check.py). The last
line of standard output is one JSON object: ``correct``, ``attempted``
and ``failed`` (frames), ``metrics``, ``device``, with ``--trace 1``
``breakdown``, ``setup_parts`` (the host clock of each step of set-up,
also printed on standard error), and last ``check``: each compared
number with its limit, which are also the last lines of standard error.

Without a CUDA device, or with fewer than the cell asks for, it exits
with 2 and prints no result; it never falls back to the CPU. It exits
with 3 and prints no result when the process holds JAX or the JAX
package once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host's parts of a frame (the game
# step, the refresh's numpy rows, the launches) run on one thread, and no
# pool of idle workers competes with them for the host's shared cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

# the profiled part of a --trace 1 window
TRACE_SECONDS = 8.0
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "merian_quake_tpu"})


def forbidden_modules(names=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is, as a
    whole, one of FORBIDDEN."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


class Run:
    """The record of one run that the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", overrides: dict | None = None, control: bool = False,
             fault=None) -> dict:
    """One run of ``cell_name``; returns the result line's object.
    ``overrides`` ({"config": {...}, "traffic": {...}}) shrink a cell for
    the CPU tests; ``control`` also judges the reference computed in
    bfloat16 (``result["control"]``); ``fault(program_cell)`` breaks the
    program under a test before its first frame."""
    import torch

    from quakebench import check, devtrace, scenes, spec

    torch.set_num_threads(1)
    cell = spec.cell(bench, cell_name)
    cfg = scenes.merge(spec.config(cell["config"]), (overrides or {}).get("config"))
    mix = scenes.merge(spec.traffic(cell["traffic"]), (overrides or {}).get("traffic"))
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spans = scenes.Spans(trace)
    t_cell = time.perf_counter()
    pc = scenes.ProgramCell(cfg, mix, seed, device, spans, fault=fault)
    t_settle = time.perf_counter()
    i = 1
    for _ in range(mix["settle_frames"]):
        pc.frame(i)
        i += 1
    sync()
    t_gc = time.perf_counter()
    # what set-up made stays: a collection in the window scans only the
    # window's own objects
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START
    parts = {"python": t_cell - T_START, **pc.parts, "settle": t_gc - t_settle,
             "gc": T_START + setup_s - t_gc}
    build = {k: spans.times.pop(k) for k in ("accel_build", "capture")}
    spans.times.clear()
    budget = min(seconds, TRACE_SECONDS) if trace else seconds
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    frames = []
    t0 = time.perf_counter()
    while True:
        f0 = time.perf_counter()
        spans("frame", lambda: (pc.frame(i), sync()))
        f1 = time.perf_counter()
        frames.append(f1 - f0)
        i += 1
        if f1 - t0 >= budget:
            break
    window_s = time.perf_counter() - t0
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        ops, host = devtrace.read_profiler(prof)
        frame_spans = [s for s in host if s[0] == "frame"]
        if frame_spans:
            own = devtrace.own_kernel_names(os.path.join(spec.ROOT, scenes.PROGRAM, "csrc"))
            inner = [s for s in host if s[0] != "frame"]
            summary = devtrace.summarize(ops, inner, (frame_spans[0][1], frame_spans[-1][2]),
                                         own)
        del prof
    mem = torch.cuda.max_memory_allocated() if cuda else 0
    t_check = time.perf_counter()
    numbers, where, control_numbers = verify(pc, cfg, mix, seed, i, device, control)
    check_s = time.perf_counter() - t_check
    record = Run(cell=cell, config=cfg, traffic=mix, frames=frames, window_s=window_s,
                 setup_s=setup_s, mem_bytes=mem, spans=spans.times, build=build,
                 profile=summary, n_tris=pc.n_tris, n_clusters=pc.n_clusters,
                 alpha=bool(pc.features.has_alpha_tris))
    metrics = {}
    for m in spec.cell_metrics(bench, cell_name, trace):
        value = spec.metric(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": mem,
           "power_limit": _power_limit() if cuda else None}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    out = {"correct": check.judge(numbers), "attempted": len(frames) + 1,
           "failed": 0 if check.judge(numbers) else 1, "metrics": metrics, "device": dev}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    if control_numbers is not None:
        out["control"] = control_numbers
    out["check_s"] = check_s
    out["setup_parts"] = parts
    out["worst_leaf"] = where
    out["check"] = check.report(numbers)
    return out


def verify(pc, cfg: dict, mix: dict, seed: int, i: int, device, control: bool):
    """Frame ``i`` of the program, from its state after the window, against
    the reference's; returns ({name: number}, {name: worst leaf}, the
    control's numbers or None)."""
    import torch

    from quakebench import check, scenes

    cuda = torch.device(device).type == "cuda"
    start = scenes.clone(pc.cf.state)
    u = pc.inputs(i)
    pc.world.before_replay(pc.cf)
    tables = pc.world.tables()
    step_input = pc.world.step_input()
    state, outputs = pc.cf(u)
    prog_state, prog_out = scenes.clone(state), scenes.clone(outputs)
    prog_init = pc.fresh_state()
    scene_host = scenes.host_scene(pc.bundle.scene)
    textures, uniforms0 = pc.textures, pc.bundle.uniforms
    pc.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = scenes.ReferenceCell(cfg, mix, seed, scene_host, textures, uniforms0, device)
    numbers, where = {}, {}

    def put(name, pair):
        numbers[name], where[name] = pair

    r_init = ref.init_state()
    put("start", check.worst(prog_init, r_init))
    del prog_init
    if tables is not None:
        put("tables", check.tables_error(tables, ref.world.follow(step_input)))
    r_start = scenes.adopt(r_init, start)
    del r_init, start
    r_u = ref.uniforms(u)
    r_state, r_out = ref.frame(scenes.clone(r_start), r_u)
    put("gbuffer", check.worst(prog_out["gbuffer"], r_out["gbuffer"]))
    put("image", check.worst({k: v for k, v in prog_out.items() if k != "gbuffer"},
                             {k: v for k, v in r_out.items() if k != "gbuffer"}))
    put("state", check.worst(prog_state, r_state))
    control_numbers = None
    if control:
        ctl = ref.with_precision("bf16")
        c_state, c_out = ctl.frame(scenes.clone(r_start), r_u)
        control_numbers = {
            "gbuffer": check.worst(c_out["gbuffer"], r_out["gbuffer"])[0],
            "image": check.worst({k: v for k, v in c_out.items() if k != "gbuffer"},
                                 {k: v for k, v in r_out.items() if k != "gbuffer"})[0],
            "state": check.worst(c_state, r_state)[0],
        }
    return numbers, where, control_numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from quakebench import spec

    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"quakebench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"quakebench: the process holds {bad} after the window", file=sys.stderr)
        return 3
    print("setup " + ", ".join(f"{k} {v:.3f}" for k, v in out["setup_parts"].items()),
          file=sys.stderr)
    for k, v in out["check"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r}; worst leaf "
              f"{out['worst_leaf'].get(k, '')})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
