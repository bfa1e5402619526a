"""MCPG's draw kernel (csrc/mcpg_draw.cu) against the torch loop (42)."""
from __future__ import annotations

import torch

from .common import H, HBM_RATE, SPP, W, cuda_time, leaf_diff, log
from .u32 import int64_chains


DRAW_SOURCE = "merian_quake_tpu_torch/csrc/mcpg_draw.cu"
DRAW_REPLACES = ("no TPU kernel: the port's torch draw loop (render/mcpg/draw.py "
                 "draw_states_reference, the K-draw reservoir loop of surface.py and volume.py); "
                 "the JAX package's is jnp code")
# frames of the captured live dungeon frame held against eager ones
DRAW_FRAMES = 6


def draw_lane_bytes(k: int, dead: bool, lookup: bool) -> int:
    """The bytes a lane of the draw kernel must move: the RNG state (8), its
    positions and normal (12 each; the volume's lookup is its position), the
    dead mask (1); out the RNG state, the winner's id, w_tgt, sum_w, w_cos,
    N and hash, its row and the score sum (60); a draw's 32-byte row and its
    mu, kappa, sum_w and N (24)."""
    return 8 + 12 * (3 if lookup else 2) + (1 if dead else 0) + 60 + k * (32 + 24)


def draw_inputs(dev, n, kind, seed):
    """n lanes around a camera: positions 0.5-3000 units away (the adaptive
    levels of a map), unit normals, a few lanes at inf and NaN; the
    surface's lanes a tenth dead and half looking up a small step off (its
    sample 0's previous position); the volume's normal the negated view
    direction."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cam = torch.tensor([120.5, -340.0, 64.75], device=dev)
    d = torch.randn(n, 3, generator=g, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    pos = cam + d * (0.5 + 3000.0 * torch.rand(n, 1, generator=g, device=dev) ** 3)
    pos[::9973] = float("inf")
    pos[5::10007, 1] = float("nan")
    nrm = torch.randn(n, 3, generator=g, device=dev)
    nrm = nrm / nrm.norm(dim=-1, keepdim=True)
    rng = torch.randint(1, 1 << 32, (n,), generator=g, device=dev, dtype=torch.int64)
    inp = {"rng": rng, "pos": pos, "normal": nrm, "cam_x": cam,
           "cl_time": torch.tensor(83.125, device=dev)}
    if kind == "surface":
        step = 0.05 * torch.randn(n, 3, generator=g, device=dev)
        inp["lookup"] = pos + step * (torch.rand(n, 1, generator=g, device=dev) < 0.5)
        inp["dead"] = torch.rand(n, generator=g, device=dev) < 0.1
    else:
        inp["lookup"], inp["normal"] = pos, -d
    return inp


def draw_call(fn, inp, kind, mcfg, table):
    return fn(inp["rng"], inp["lookup"], inp["pos"], inp["normal"], inp["cam_x"], inp["cl_time"],
              table, mcfg, **({"dead": inp["dead"], "hemisphere": True} if kind == "surface"
                              else {}))


def draw_table(dev, inp, kind, mcfg, seed):
    """A draw table of the configuration's size whose rows meet the lanes'
    draws: random states (a fifth tombstoned), then the hash each draw
    expects written into the row it gathers for 70% of the lanes (a mixed
    slot's adaptive or static hash at random), found by a run of the torch
    loop that records its gathers and finalizes."""
    from merian_quake_tpu_torch.render.mcpg import draw, grids

    g = torch.Generator(device=dev).manual_seed(seed)
    S, n = mcfg.mc_total_size, inp["rng"].shape[0]
    f = torch.empty((S, 5), device=dev)
    f[:, 3] = torch.rand(S, generator=g, device=dev) * 8.0
    f[:, 0:3] = (inp["cam_x"] + 500.0 * torch.randn(S, 3, generator=g, device=dev)) * f[:, 3:4]
    f[:, 4] = f[:, 3] * torch.rand(S, generator=g, device=dev)
    f[:, 3] = torch.where(torch.rand(S, generator=g, device=dev) < 0.2, -1.0, f[:, 3])
    i = torch.stack([torch.randint(-(1 << 31), 1 << 31, (S,), generator=g, device=dev),
                     torch.randint(0, 1025, (S,), generator=g, device=dev),
                     torch.randint(0, 1 << 16, (S,), generator=g, device=dev)], -1).int()
    table = torch.cat([f.view(torch.int32), i], 1)
    rows, hashes = [], []
    gather, finalize = grids.gather_state_packed_draw, grids.finalize_load

    def rec_gather(packed, idx):
        rows.append(idx.clone())
        hashes.append([])
        return gather(packed, idx)

    def rec_finalize(st, expected, *a, **k):
        hashes[-1].append(expected.clone())
        return finalize(st, expected, *a, **k)

    grids.gather_state_packed_draw, grids.finalize_load = rec_gather, rec_finalize
    try:
        with int64_chains():
            draw_call(draw.draw_states_reference, inp, kind, mcfg, table)
    finally:
        grids.gather_state_packed_draw, grids.finalize_load = gather, finalize
    for r, h in zip(rows, hashes):
        want = h[0] if len(h) == 1 else torch.where(
            torch.rand(n, generator=g, device=dev) < 0.5, h[0], h[1])
        hit = torch.rand(n, generator=g, device=dev) < 0.7
        table[r[hit], 7] = want[hit].int()
    return table


def draw_leaves(d) -> dict:
    """The outputs of a draw loop by name."""
    out = {"rng": d.rng, "win_buf": d.win_buf, "score_sum": d.score_sum}
    out |= {f"win.{k}": v for k, v in d.win._asdict().items()}
    for name in ("mu", "kappa", "sum_w", "N"):
        out |= {f"{name}[{k}]": v for k, v in enumerate(getattr(d, name))}
    return out


def draw_random(dev, smi):
    """The kernel against the torch loop on the card, bit for bit on every
    output: the 1080p × 2 spp surface population and the 1080p volume
    population on the production-size table (production_config()), then a
    37x53 input of each under the production settings, with no mixed slot
    (K·p = 3.0) and with grid_tile_bits 2. Returns {leaf: worst (differ,
    abs, rel)}."""
    from merian_quake_tpu_torch.render.mcpg import draw
    from merian_quake_tpu_torch.render.mcpg.config import production_config

    prod = production_config()
    worst = {}
    cases = [(f"{kind} {n} lanes", kind, n, prod)
             for kind, n in (("surface", W * H * SPP), ("volume", W * H))]
    cases += [(f"{kind} 37x53{tag}", kind, 37 * 53, mcfg) for kind in ("surface", "volume")
              for tag, mcfg in (("", prod), (" K·p 3.0", prod._replace(mc_samples_adaptive_prob=0.6)),
                                (" tile 2", prod._replace(grid_tile_bits=2)))]
    for j, (label, kind, n, mcfg) in enumerate(cases):
        inp = draw_inputs(dev, n, kind, 4200 + j)
        table = draw_table(dev, inp, kind, mcfg, 4300 + j)
        got = draw_leaves(draw_call(draw.draw_states, inp, kind, mcfg, table))
        with int64_chains():
            ref = draw_leaves(draw_call(draw.draw_states_reference, inp, kind, mcfg, table))
        res = leaf_diff(f"draw kernel, {label} [{smi}]", got, ref, phase=42)
        hits = float((ref["score_sum"] > 0).float().mean())
        log(f"phase 42 {label}: lanes with a weighted draw {hits:.3f}, winner rows "
            f"{float((ref['win_buf'] >= 0).float().mean()):.3f}")
        for k, v in res.items():
            worst[f"{label} {k}"] = v
        del table
    return worst


def draw_captured(dev, smi):
    """The benchmark's mcpg_default live dungeon frame (quakebench's
    ProgramCell: production_config() at 1080p, 2 spp, fog): the launches its
    capture records (a surface draw a bounce segment, a volume draw a volume
    sample: 4), then DRAW_FRAMES moving frames captured against eager
    render_frame on a second copy of the live tables with the torch loop,
    every state leaf and output. Returns ({leaf: worst}, launches in the
    graph)."""
    from merian_quake_tpu_torch.accel.build import build_accel_live, refresh_dynamic
    from merian_quake_tpu_torch.capture import WARMUP_STEPS, tree_leaves, tree_map
    from merian_quake_tpu_torch.render.mcpg import draw
    from merian_quake_tpu_torch.renderer import render_frame
    from quakebench import scenes, spec

    draw.draw_states.launches = 0
    cell = scenes.ProgramCell(spec.config("mcpg_default"), spec.traffic("live_dungeon"),
                              2300000042, dev, scenes.Spans(False))
    torch.cuda.synchronize()
    count = draw.draw_states.launches
    if count % (WARMUP_STEPS + 1):
        raise AssertionError(f"phase 42: {count} draw launches over the warm-up and the capture")
    in_graph = count // (WARMUP_STEPS + 1)
    game = cell.world.game
    la_e = build_accel_live(cell.bundle, dyn_cap=game.gs.dynamic_capacity, device=dev)
    clone = lambda x: tree_map(torch.clone, x)
    plain, worst = draw.draw_states, {}
    for i in range(1, DRAW_FRAMES + 1):
        u = cell.inputs(i)
        cell.world.before_replay(cell.cf)
        refresh_dynamic(la_e, cell.world.dyn)
        before = clone(cell.cf.state)
        draw.draw_states = draw.draw_states_reference
        try:
            with int64_chains():
                ref_st, ref_out = render_frame(la_e.accel, cell.bundle.atlas, u, cell.config,
                                               before, mcpg_config=cell.icfg)
        finally:
            draw.draw_states = plain
        st, out = cell.cf(u)
        got = {f"state {k}": x for k, x in enumerate(tree_leaves(st))}
        got |= {f"out {k}": x for k, x in enumerate(tree_leaves(out))}
        ref = {f"state {k}": x for k, x in enumerate(tree_leaves(ref_st))}
        ref |= {f"out {k}": x for k, x in enumerate(tree_leaves(ref_out))}
        res = leaf_diff(f"captured live dungeon mcpg_default frame {i} against eager with the "
                        "torch draw loop", got, ref, phase=42)
        for k, v in res.items():
            worst[k] = max(worst.get(k, (0, 0.0, 0.0)), v)
        del before, ref_st, ref_out
    if draw.draw_states.launches != count:
        raise AssertionError("phase 42: a replay or the eager torch loop counted a draw launch")
    mc = cell.cf.state.mcpg.mc
    log(f"phase 42 captured live dungeon mcpg_default [{smi}]: draw launches in the graph "
        f"{in_graph}; chain states with sum_w > 0 after {DRAW_FRAMES + 1} frames "
        f"{int((mc.f[:, 3] > 0).sum())}")
    cell.release()
    del la_e
    return worst, in_graph


def draw_timing(dev, smi):
    """The kernel alone at 1080p (the surface's 4,147,200 lanes, the
    volume's 2,073,600) on the production-size table, by CUDA events,
    against its bytes floor and the torch loop it replaces."""
    from merian_quake_tpu_torch.render.mcpg import draw
    from merian_quake_tpu_torch.render.mcpg.config import production_config

    mcfg = production_config()
    out = {}
    for kind, n in (("surface", W * H * SPP), ("volume", W * H)):
        inp = draw_inputs(dev, n, kind, 4400)
        table = draw_table(dev, inp, kind, mcfg, 4401)
        call = lambda fn: draw_call(fn, inp, kind, mcfg, table)
        call(draw.draw_states)
        ms = cuda_time(lambda: call(draw.draw_states), 20)
        with int64_chains():
            plain = cuda_time(lambda: call(draw.draw_states_reference), 3)
        nbytes = n * draw_lane_bytes(mcfg.mc_samples, kind == "surface", kind == "surface")
        out[kind] = {"ms": ms, "plain_ms": plain, "bound_ms": nbytes / HBM_RATE * 1e3,
                     "bound_by": "bytes", "lanes": n, "bytes": nbytes}
        log(f"phase 42 draw kernel alone [{smi}], {kind} {n} lanes: {ms:.3f} ms (bytes floor "
            f"{out[kind]['bound_ms']:.3f} ms, {nbytes / 1e9:.2f} GB); the torch loop {plain:.2f} ms")
        del table
    return out


def phase42(dev, smi):
    """MCPG's draw kernel (csrc/mcpg_draw.cu): bit for bit against the torch
    loop on seeded 1080p surface and volume populations on the production
    table and on 37x53 inputs; the captured mcpg_default live dungeon frame
    against eager frames on the torch loop (DRAW_FRAMES frames, every leaf)
    and the launches its graph records (4); then the kernel alone against
    its bytes floor and the torch loop. Returns the readings."""
    worst = draw_random(dev, smi)
    captured, in_graph = draw_captured(dev, smi)
    every = {**worst, **{f"captured {k}": v for k, v in captured.items()}}
    bad = {k: v for k, v in every.items() if v[0]}
    if bad:
        raise AssertionError(f"phase 42: the draw kernel differs from the torch loop: {bad}")
    if in_graph != 4:
        raise AssertionError(f"phase 42: a captured mcpg_default frame records {in_graph} draw "
                             "launches, expected 4 (2 surface segments, 2 volume samples)")
    timing = draw_timing(dev, smi)
    log(f"phase 42 the draw kernel [{smi}]: bit for bit against the torch loop on {len(every)} "
        f"leaves; {in_graph} launches a captured mcpg_default frame")
    return {"by_population": timing, "launches_in_graph": in_graph, "leaves_compared": len(every),
            "max_abs_err": 0.0}
