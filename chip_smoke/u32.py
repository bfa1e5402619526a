"""The u32 RNG and hash-grid chains (csrc/u32_chains.cu) against their
int64 torch references (43)."""
from __future__ import annotations

import contextlib

import torch

from .common import H, HBM_RATE, SPP, W, cuda_time, leaf_diff, log


CHAINS_SOURCE = "merian_quake_tpu_torch/csrc/u32_chains.cu"
CHAINS_REPLACES = ("no TPU kernel: the port's int64 u32 emulation (ops/rng.py seed_pixel_reference "
                   "and uniforms_reference, render/mcpg/grids.py cell_reference, "
                   "render/mcpg/light_cache.py lookup_reference); the JAX package's chains are "
                   "jnp uint32 code")
# frames of the captured live dungeon frame held against eager ones
CHAINS_FRAMES = 6
# each entry point: the bytes a lane must move (in + out), lc_lookup's
# 20-byte row included: seed_pixel px, py (int32) and a per-lane seed
# (int64) in, the state out; uniforms the state in and out and 4·k floats;
# a cell the state, position and (adaptive, light cache) normal in, the
# state, slot and hash out; the lookup those in, the state, irradiance and
# N out, its row
LANE_BYTES = {"seed_pixel": 4 + 4 + 8 + 8, "uniforms k=3": 8 + 8 + 12,
              "cell adaptive": 8 + 24 + 24, "cell static": 8 + 12 + 24,
              "lc_lookup": 8 + 24 + 1 + 20 + 8 + 12 + 4}


def _wrappers():
    from merian_quake_tpu_torch.ops import rng
    from merian_quake_tpu_torch.render.mcpg import grids, light_cache

    return {"seed_pixel": (rng, "seed_pixel", rng.seed_pixel_reference),
            "uniforms": (rng, "uniforms", rng.uniforms_reference),
            "cell": (grids, "cell", grids.cell_reference),
            "lc_lookup": (light_cache, "lookup", light_cache.lookup_reference)}


WRAPPERS = {}


def wrapper(name):
    """The kernel wrapper ``name`` as the port binds it (not the plain
    version :func:`int64_chains` may have put in its place)."""
    if not WRAPPERS:
        WRAPPERS.update({k: getattr(m, a) for k, (m, a, _) in _wrappers().items()})
    return WRAPPERS[name]


def chain_launches() -> dict:
    return {k: wrapper(k).launches for k in _wrappers()}


def reset_chain_launches() -> None:
    for k in _wrappers():
        wrapper(k).launches = 0


@contextlib.contextmanager
def int64_chains():
    """Every u32 chain on its int64 torch reference, on any device: the four
    wrappers swapped for their plain versions, which call only plain
    versions."""
    swaps = _wrappers()
    for k, (module, attr, plain) in swaps.items():
        wrapper(k)
        setattr(module, attr, plain)
    try:
        yield
    finally:
        for k, (module, attr, _) in swaps.items():
            setattr(module, attr, wrapper(k))


def chain_inputs(dev, n, seed):
    """n lanes around a camera as draw_inputs makes them (positions 0.5-3000
    units away, a few at inf and NaN, unit normals), the positions read
    through a strided view of an [n, 4] array; seeded states with a zero, the
    xorshift fixed point 0 and the top of the range; int32 pixels of a 1080p
    image a sample, a per-lane seed, the frame as a device scalar; a tenth
    of the lanes dead; a float level per lane (-3..40, a few NaN)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cam = torch.tensor([120.5, -340.0, 64.75], device=dev)
    d = torch.randn(n, 3, generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    pos4 = torch.zeros(n, 4, device=dev)
    pos4[:, :3] = cam + d * (0.5 + 3000.0 * torch.rand(n, 1, generator=g, device=dev) ** 3)
    pos4[::9973, :3] = float("inf")
    pos4[5::10007, 1] = float("nan")
    nrm = torch.randn(n, 3, generator=g, device=dev)
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    rng = torch.randint(0, 1 << 32, (n,), generator=g, device=dev, dtype=torch.int64)
    rng[:4] = torch.tensor([0, 1, (1 << 32) - 1, 1 << 31], device=dev)
    lane = torch.arange(n, device=dev, dtype=torch.int64)
    level = torch.randint(-3, 41, (n,), generator=g, device=dev).float()
    level[7::5003] = float("nan")
    return {"rng": rng, "pos": pos4[:, :3], "normal": nrm, "cam_x": cam, "level": level,
            "px": (lane % W).int(), "py": (lane // W % H).int(),
            "seed": (1337 ^ ((lane // (W * H)) * 0x9E3779B9)) & 0xFFFFFFFF,
            "frame": torch.tensor(4000123, device=dev, dtype=torch.int64),
            "dead": torch.rand(n, generator=g, device=dev) < 0.1,
            "queue": torch.randint(-(1 << 31), 1 << 31, (n, 16), generator=g, device=dev,
                                   dtype=torch.int64).int()}


def lc_table(dev, inp, mcfg, seed):
    """A light-cache table of the configuration's size (i32[lc_size, 5]):
    random hashes, irradiance (a tenth of rows inf or NaN) and N, then the
    hash each lane's cell expects written into its row for 70% of the lanes,
    found by the plain version."""
    from merian_quake_tpu_torch.render.mcpg import grids, light_cache

    g = torch.Generator(device=dev).manual_seed(seed)
    L = mcfg.lc_size
    irr = torch.rand(L, 3, generator=g, device=dev) * 4.0
    irr[torch.rand(L, generator=g, device=dev) < 0.05, 1] = float("inf")
    irr[torch.rand(L, generator=g, device=dev) < 0.05, 2] = float("nan")
    table = torch.cat([torch.randint(0, 1 << 16, (L, 1), generator=g, device=dev).int(),
                       irr.view(torch.int32),
                       torch.randint(0, 1 << 20, (L, 1), generator=g, device=dev).int()], 1)
    for level in (inp["level"], light_cache._lc_level(inp["pos"], inp["cam_x"], mcfg)):
        _, buf, h = grids.cell_reference(inp["rng"], inp["pos"], mcfg, "light_cache",
                                         normal=inp["normal"], level=level)
        hit = torch.rand(buf.shape[0], generator=g, device=dev) < 0.7
        table[buf[hit], 0] = h[hit].int()
    return table.contiguous()


def chain_calls(inp, mcfg, table):
    """Every entry point's calls on ``inp``: {label: fn(impl) → outputs},
    where impl maps a wrapper's name to the function to call."""
    q = inp["queue"]
    return {
        "seed_pixel pixels": lambda f: f["seed_pixel"](inp["px"], inp["py"], inp["frame"],
                                                        inp["seed"]),
        "seed_pixel queue column": lambda f: f["seed_pixel"](q[:, 15], 0, inp["frame"], 987654321),
        "seed_pixel scalar seed": lambda f: f["seed_pixel"](inp["rng"], 2, 0, inp["rng"][3]),
        "seed_pixel cpu scalar": lambda f: f["seed_pixel"](inp["px"], inp["py"],
                                                           torch.tensor(2 ** 31 + 5), 2 ** 32 - 3),
        **{f"uniforms k={k}": (lambda f, k=k: f["uniforms"](inp["rng"], k)) for k in (1, 2, 3, 4, 5)},
        "cell adaptive": lambda f: f["cell"](inp["rng"], inp["pos"], mcfg, "adaptive",
                                             normal=inp["normal"], cam_x=inp["cam_x"]),
        "cell adaptive target given": lambda f: f["cell"](inp["rng"], inp["pos"], mcfg, "adaptive",
                                                          normal=inp["normal"], level=inp["level"]),
        "cell static": lambda f: f["cell"](inp["rng"], inp["pos"], mcfg, "static"),
        "cell light_cache level given": lambda f: f["cell"](inp["rng"], inp["pos"], mcfg,
                                                            "light_cache", normal=inp["normal"],
                                                            level=inp["level"]),
        "lc_lookup": lambda f: f["lc_lookup"](inp["rng"], table, inp["pos"], inp["normal"], mcfg,
                                              cam_x=inp["cam_x"]),
        "lc_lookup dead": lambda f: f["lc_lookup"](inp["rng"], table, inp["pos"], inp["normal"],
                                                   mcfg, cam_x=inp["cam_x"], dead=inp["dead"]),
        "lc_lookup level given": lambda f: f["lc_lookup"](inp["rng"], table, inp["pos"],
                                                          inp["normal"], mcfg,
                                                          level=inp["level"]),
    }


def _leaves(out) -> dict:
    out = out if isinstance(out, tuple) else (out,)
    return {str(k): x for k, x in enumerate(out)}


def chains_random(dev, smi):
    """Every entry point against its int64 reference on the card, bit for
    bit on every output: the 1080p × 2 spp surface population and the 1080p
    population on production_config()'s grids and light cache, then 37x53
    inputs, each in the scrambled layout and with grid_tile_bits 2. Returns
    {leaf: worst (differ, abs, rel)}."""
    from merian_quake_tpu_torch.render.mcpg.config import production_config

    prod = production_config()
    kernel = {k: wrapper(k) for k in _wrappers()}
    plain = {k: p for k, (_, _, p) in _wrappers().items()}
    worst, hits = {}, []
    cases = [(f"{n} lanes{tag}", n, mcfg) for n in (W * H * SPP, W * H, 37 * 53)
             for tag, mcfg in (("", prod), (" tile 2", prod._replace(grid_tile_bits=2)))]
    for j, (label, n, mcfg) in enumerate(cases):
        inp = chain_inputs(dev, n, 4300 + j)
        table = lc_table(dev, inp, mcfg, 4400 + j)
        for name, call in chain_calls(inp, mcfg, table).items():
            got, ref = _leaves(call(kernel)), _leaves(call(plain))
            res = leaf_diff(f"u32 chains, {name}, {label} [{smi}]", got, ref, phase=43)
            for k, v in res.items():
                worst[f"{label} {name} {k}"] = v
            if name == "lc_lookup":
                hits.append(float((ref["2"] > 0).float().mean()))
        del table
    log(f"phase 43: share of lanes whose light-cache lookup found its cell, by case {hits}")
    return worst


def chains_captured(dev, smi):
    """The benchmark's mcpg_default live dungeon frame (quakebench's
    ProgramCell): the launches of each chain its capture records, then
    CHAINS_FRAMES moving frames captured against eager render_frame on a
    second copy of the live tables with every chain on its int64 reference,
    every state leaf and output. Returns ({leaf: worst}, launches in the
    graph by chain)."""
    from merian_quake_tpu_torch.accel.build import build_accel_live, refresh_dynamic
    from merian_quake_tpu_torch.capture import WARMUP_STEPS, tree_leaves, tree_map
    from merian_quake_tpu_torch.renderer import render_frame
    from quakebench import scenes, spec

    reset_chain_launches()
    cell = scenes.ProgramCell(spec.config("mcpg_default"), spec.traffic("live_dungeon"),
                              2600000042, dev, scenes.Spans(False))
    torch.cuda.synchronize()
    counts = chain_launches()
    if any(c % (WARMUP_STEPS + 1) for c in counts.values()):
        raise AssertionError(f"phase 43: launches over the warm-up and the capture {counts}")
    in_graph = {k: c // (WARMUP_STEPS + 1) for k, c in counts.items()}
    game = cell.world.game
    la_e = build_accel_live(cell.bundle, dyn_cap=game.gs.dynamic_capacity, device=dev)
    clone = lambda x: tree_map(torch.clone, x)
    worst = {}
    for i in range(1, CHAINS_FRAMES + 1):
        u = cell.inputs(i)
        cell.world.before_replay(cell.cf)
        refresh_dynamic(la_e, cell.world.dyn)
        before = clone(cell.cf.state)
        with int64_chains():
            ref_st, ref_out = render_frame(la_e.accel, cell.bundle.atlas, u, cell.config, before,
                                           mcpg_config=cell.icfg)
        st, out = cell.cf(u)
        got = {f"state {k}": x for k, x in enumerate(tree_leaves(st))}
        got |= {f"out {k}": x for k, x in enumerate(tree_leaves(out))}
        ref = {f"state {k}": x for k, x in enumerate(tree_leaves(ref_st))}
        ref |= {f"out {k}": x for k, x in enumerate(tree_leaves(ref_out))}
        res = leaf_diff(f"captured live dungeon mcpg_default frame {i} against eager with the "
                        "int64 chains", got, ref, phase=43)
        for k, v in res.items():
            worst[k] = max(worst.get(k, (0, 0.0, 0.0)), v)
        del before, ref_st, ref_out
    if chain_launches() != counts:
        raise AssertionError("phase 43: a replay or the eager int64 frames counted a launch")
    log(f"phase 43 captured live dungeon mcpg_default [{smi}]: launches in the graph {in_graph} "
        f"({sum(in_graph.values())} in all)")
    cell.release()
    del la_e
    return worst, in_graph


def chains_timing(dev, smi):
    """Each entry point alone on the surface's 4,147,200 lanes on
    production_config(), by CUDA events, against its bytes floor and its
    int64 reference."""
    from merian_quake_tpu_torch.render.mcpg.config import production_config

    mcfg = production_config()
    n = W * H * SPP
    inp = chain_inputs(dev, n, 4500)
    table = lc_table(dev, inp, mcfg, 4501)
    calls = chain_calls(inp, mcfg, table)
    kernel = {k: wrapper(k) for k in _wrappers()}
    plain = {k: p for k, (_, _, p) in _wrappers().items()}
    out = {}
    for name, label in (("seed_pixel", "seed_pixel pixels"), ("uniforms k=3", "uniforms k=3"),
                        ("cell adaptive", "cell adaptive"), ("cell static", "cell static"),
                        ("lc_lookup", "lc_lookup dead")):
        call = calls[label]
        call(kernel)
        ms = cuda_time(lambda: call(kernel), 20)
        plain_ms = cuda_time(lambda: call(plain), 3)
        nbytes = n * LANE_BYTES[name]
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": nbytes / HBM_RATE * 1e3,
                     "bound_by": "bytes", "lanes": n, "bytes": nbytes}
        log(f"phase 43 {name} alone [{smi}], {n} lanes: {ms:.4f} ms (bytes floor "
            f"{out[name]['bound_ms']:.4f} ms, {nbytes / 1e6:.1f} MB); the int64 reference "
            f"{plain_ms:.3f} ms")
    del table
    return out


def phase43(dev, smi):
    """The u32 chains (csrc/u32_chains.cu): every entry point bit for bit
    against its int64 reference on seeded 1080p populations and 37x53 inputs
    on production_config()'s grids, in both layouts, with dead lanes; the
    captured mcpg_default live dungeon frame against eager frames on the
    int64 chains (CHAINS_FRAMES frames, every leaf) and the launches of each
    chain its graph records; then each kernel alone against its bytes floor
    and its reference. Returns the readings."""
    worst = chains_random(dev, smi)
    captured, in_graph = chains_captured(dev, smi)
    every = {**worst, **{f"captured {k}": v for k, v in captured.items()}}
    bad = {k: v for k, v in every.items() if v[0]}
    if bad:
        raise AssertionError(f"phase 43: the u32 chains differ from the int64 references: {bad}")
    if not all(in_graph.values()):
        raise AssertionError(f"phase 43: a chain records no launch in the graph: {in_graph}")
    timing = chains_timing(dev, smi)
    log(f"phase 43 the u32 chains [{smi}]: bit for bit against the int64 references on "
        f"{len(every)} leaves; launches a captured mcpg_default frame {in_graph}")
    return {"by_entry": timing, "launches_in_graph": in_graph, "leaves_compared": len(every),
            "max_abs_err": 0.0}
