"""The native accel builder (35), a .bsp room through the loaders (36)
and row slabs on gloo ranks sharing the card (37)."""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .common import (
    H, MEAN_TOL, MPL, PIX_SHARE, PIX_TOL, SPP, SUBSET, W, check_exact, frames_run, launches,
    log, reset_launches,
)
from .fixtures import MAP, primary_rays, room_bsp


def table_diff(a, b) -> dict:
    """Two accels' tables, field by field: equal in value, and equal bit
    for bit (the sign of a zero counts); the Woop rows' largest
    difference."""
    fields = ("woop_w", "woop_w_shadow", "woop_w_alpha", "woop_w_proxy", "cluster_lo",
              "cluster_hi", "cluster_lo_proxy", "cluster_hi_proxy", "tri_attr", "candidate")
    bits = lambda x: x if x.dtype == torch.bool else x.view(torch.uint8)
    value, bit = {}, {}
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        both = x is not None and y is not None
        value[f] = (x is None and y is None) or (both and torch.equal(x, y))
        bit[f] = (x is None and y is None) or (both and torch.equal(bits(x), bits(y)))
    return {"value_equal": value, "bit_equal": bit,
            "woop_max_abs": float((a.woop_w - b.woop_w).abs().max())}


def phase35(dev, smi, native_build_s):
    """The native accel builder: native against numpy on city and on the
    map (seconds, tables bit for bit, the Woop rows' largest difference);
    K1 and K3 on native-built tables against their plain versions on
    65,536 primary rays; a cluster="morton" city renders a finite 1080p PT
    frame (K1)."""
    from merian_quake_tpu_torch.accel import build_accel, woop
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.utils import native

    stats, max_abs = {"g++_s": native_build_s, "flags": " ".join(native.CXXFLAGS)}, []
    accels = {}
    for name, kw in (("city", {}), ("map", MAP)):
        bundle = city(**kw, device=dev)
        secs = {}
        for route in ("native", "numpy"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc = build_accel(bundle.scene, bundle.atlas, native=route == "native")
            torch.cuda.synchronize()
            secs[route] = time.perf_counter() - t0
            accels[(name, route)] = acc
        d = table_diff(accels[(name, "native")], accels[(name, "numpy")])
        stats[name] = {"tris": bundle.scene.num_tris, "native_s": secs["native"],
                       "numpy_s": secs["numpy"], **d}
        log(f"phase 35 build_accel {name} ({bundle.scene.num_tris} triangles) [{smi}]: native "
            f"{secs['native']:.3f} s, numpy {secs['numpy']:.3f} s; Woop rows' largest "
            f"difference {d['woop_max_abs']:.3e}; equal in value {d['value_equal']}; bit for bit "
            f"{d['bit_equal']}")
        # tests/test_torch_native.py's bounds: Woop rows within 1e-6 relative,
        # the rest equal
        na, nu = accels[(name, "native")], accels[(name, "numpy")]
        woop_ok = all(torch.allclose(getattr(na, f), getattr(nu, f), rtol=1e-6, atol=0)
                      for f in ("woop_w", "woop_w_shadow") if getattr(na, f) is not None)
        if not woop_ok or not all(v for f, v in d["value_equal"].items()
                                  if not f.startswith("woop_w")):
            raise AssertionError(f"{name}: the native and numpy tables differ")
        acc = accels[(name, "native")]
        po, pd = primary_rays(bundle, acc, dev)
        mid = slice(W * H // 2, W * H // 2 + SUBSET)
        full = lambda v: torch.full((SUBSET,), v, device=dev)
        args = woop.k1_inputs(acc, po[mid].contiguous(), pd[mid].contiguous(), full(0.0),
                              full(1e4))
        kernel = woop.woop_stream if woop.streamed(acc.woop_w) else woop.woop_nearest
        ref = woop.intersect_woop_reference(args[0], args[1])
        max_abs.append(check_exact(35, f"{name} native-built primary {SUBSET} "
                                       f"{kernel.__name__}", kernel(*args), ref))
    # the Morton order: a whole PT frame
    bundle = city(device=dev)
    t0 = time.perf_counter()
    acc = build_accel(bundle.scene, bundle.atlas, cluster="morton")
    morton_s = time.perf_counter() - t0
    config = RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL,
                          features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas))
    _, out, counts, ms, _ = frames_run(35, "pt_morton", dev, bundle, acc, config, None, 3, (1, 3),
                                       {"woop_nearest": 1 + SPP * (MPL - 1)}, smi,
                                       W * H * (1 + SPP * (MPL - 1)))
    stats["morton"] = {"build_s": morton_s, "ms": float(np.mean(ms[1:]))}
    stats["max_abs_err"] = max(max_abs)
    log(f"phase 35 cluster=morton city: build {morton_s:.3f} s (native), 1080p PT frames "
        f"{np.mean(ms[1:]):.1f} ms/frame, finite")
    return {"pt_morton": counts}, stats


def phase36(dev, smi):
    """.bsp/.pak loading: room_bsp() written into a .pak, read back through
    PakFile → load_bsp → scene_from_bsp(device=card) → build_accel, a 1080p
    PT frame through K1; 64x40 PT frames on the CPU and on the card."""
    import os
    import tempfile

    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.bsp import load_bsp
    from merian_quake_tpu_torch.models.extract import scene_from_bsp
    from merian_quake_tpu_torch.models.pak import PakFile, write_pak
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.renderer import render_sequence

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pak0.pak")
        write_pak(path, {"maps/room.bsp": room_bsp()})
        t0 = time.perf_counter()
        data = PakFile(path).read("maps/room.bsp")
    bsp = load_bsp(data)
    bundle = scene_from_bsp(bsp)  # the card: the default device
    if bundle.scene.v0.device.type != "cuda" or bundle.atlas.data.device.type != "cuda":
        raise AssertionError("scene_from_bsp did not place its bundle on the card")
    acc = build_accel(bundle.scene, bundle.atlas)
    load_s = time.perf_counter() - t0
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    config = RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL, features=feats)
    _, out, counts, ms, _ = frames_run(36, "pt_bsp", dev, bundle, acc, config, None, 3, (1, 3),
                                       {"woop_nearest": 1 + SPP * (MPL - 1)}, smi,
                                       W * H * (1 + SPP * (MPL - 1)))
    # CPU against card at 64x40. The floor's texels are 4 world units wide
    # and the eye sits at a whole unit, so on one image row the primary hits
    # land on texel borders, where nearest sampling takes either texel by
    # an ulp of the hit (Moller-Trumbore on the CPU, Woop on the card); a
    # bounce from there, or from an edge of the room, can take another path,
    # and one firefly moves the whole image's exposure. So: the direct-light
    # frames (max path length 1) in full, LDR and HDR; the full frames' HDR
    # on the pixels whose first-hit albedo agrees, with the rest counted
    small = RenderConfig(width=64, height=40, spp=SPP, features=feats)
    runs = {}
    for device in ("cpu", dev):
        b = scene_from_bsp(load_bsp(data), device=device)
        for mpl in (1, MPL):
            state, o = render_sequence(b, small._replace(max_path_length=mpl), frames=2,
                                       device=device)
            runs[(str(device), mpl)] = {"ldr": o["ldr"].cpu(), "hdr": o["hdr"].cpu(),
                                        "albedo": state.accum_albedo[..., :3].cpu()}
    reading = lambda x, y, m: (float(((x - y).abs().amax(-1) <= PIX_TOL)[m].float().mean()),
                               float((x - y).abs()[m].mean()))
    every = torch.ones((40, 64), dtype=torch.bool)
    cpu1, card1 = runs[("cpu", 1)], runs[(str(dev), 1)]
    cpu3, card3 = runs[("cpu", MPL)], runs[(str(dev), MPL)]
    same_hit = (cpu3["albedo"] - card3["albedo"]).abs().amax(-1) <= PIX_TOL
    read = {"direct_ldr": reading(cpu1["ldr"], card1["ldr"], every),
            "direct_hdr": reading(cpu1["hdr"], card1["hdr"], every),
            "full_hdr_same_first_hit": reading(cpu3["hdr"], card3["hdr"], same_hit),
            "full_ldr": reading(cpu3["ldr"], card3["ldr"], every),
            "first_hit_albedo_differs": int((~same_hit).sum())}
    log(f"phase 36 room.bsp from a .pak: {int(bundle.scene.valid.sum())} triangles, "
        f"{len(bsp.textures)} textures, sun {bsp.entities[0].get('_sunlight')}; load + extract + "
        f"build {load_s:.3f} s; 1080p PT {np.mean(ms[1:]):.1f} ms/frame; cpu vs cuda 64x40 x2 "
        f"frames (pixels within {PIX_TOL}, mean |d|): {read}")
    held = [read[k] for k in ("direct_ldr", "direct_hdr", "full_hdr_same_first_hit")]
    if any(share < PIX_SHARE or mean >= MEAN_TOL for share, mean in held) \
            or read["first_hit_albedo_differs"] > 0.01 * 64 * 40:
        raise AssertionError("the .bsp frame: CPU and card disagree")
    return {"pt_bsp": counts}, {"load_s": load_s, "ms": float(np.mean(ms[1:])), **read}


# the sharded frames (phase 37): three gloo ranks share the one card; each
# renders a 360-row slab of the 1080p frame, which tiles
# (scripts/multichip_torch.py runs the phase with one card a rank)
RANKS, SHARD_FRAMES = 3, 4


def _shard_rank(mesh, kind, frames):
    """One rank of phase 37: ``frames`` frames of this rank's slab of the
    city at 1080p (``kind``: "mcpg", "restir" or "pt_denoise"), the launch
    counts set to 0 just before and read just after each frame, the bytes
    it received from all_gather. Returns what the parent holds."""
    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.parallel import render as par
    from merian_quake_tpu_torch.post import sharded
    from merian_quake_tpu_torch.render.mcpg import updates

    bundle = city(device=mesh.device)
    acc = build_accel(bundle.scene, bundle.atlas)
    config, icfg = shard_config(kind, scene_features(bundle.scene, bundle.uniforms, bundle.atlas),
                                mesh.size)
    state = par.init_state_sharded(mesh, config, icfg)
    got = [0]
    gather = sharded.ShardCtx.all_gather

    def counted(self, x):
        got[0] += x.numel() * x.element_size() * self.n
        return gather(self, x)

    sharded.ShardCtx.all_gather = counted
    # the live rows each slab's queues hold before their compaction to
    # capacity / n (kept as tensors: no host read inside a frame)
    compact = updates.compact_queues
    live = []

    def counting(result, mcfg, *a, **kw):
        S = mcfg.mc_total_size
        lmask = result.lc_samples.mask & torch.isfinite(result.lc_samples.irr).all(-1)
        live.append(torch.stack([(result.updates.data[:, 14] < S).sum(), lmask.sum(),
                                 result.zeros.mask.sum()]))
        return compact(result, mcfg, *a, **kw)

    updates.compact_queues = counting
    per_frame, ms, bytes_, ldr0 = [], [], [], None
    try:
        for i in range(frames):
            reset_launches()
            got[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, ldr, hdr = par.render_frame_sharded(
                mesh, acc, bundle.atlas, bundle.uniforms._replace(frame=i), config, state, icfg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            per_frame.append(launches())
            bytes_.append(got[0])
            ldr0 = ldr.cpu() if ldr0 is None else ldr0
    finally:
        sharded.ShardCtx.all_gather = gather
        updates.compact_queues = compact
    out = {"ldr": ldr.cpu(), "hdr": hdr.cpu(), "ldr0": ldr0, "ms": ms, "launches": per_frame,
           "gather_bytes": bytes_, "live_rows": [x.tolist() for x in live]}
    if state.mcpg is not None:
        out.update(mc_f=state.mcpg.mc.f.cpu(), mc_i=state.mcpg.mc.i.cpu(),
                   lc_irr=state.mcpg.lc.irr.cpu(), lc_hash=state.mcpg.lc.hash.cpu(),
                   lc_n=state.mcpg.lc.N.cpu())
    if state.svgf is not None:
        out["svgf_irr"] = state.svgf.irr.cpu()
    return out


def shard_config(kind, feats, ranks):
    """(RenderConfig, integrator config) of a phase 37 run on ``ranks``
    slabs."""
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig

    kw = dict(width=W, height=H, spp=SPP, max_path_length=MPL, features=feats)
    if kind == "mcpg":
        return RenderConfig(**kw, integrator="mcpg"), MCPGConfig()
    if kind == "mcpg_wide":
        # each slab's share of the queue capacities = MCPGConfig()'s whole
        c = MCPGConfig()
        return RenderConfig(**kw, integrator="mcpg"), c._replace(
            update_queue_capacity=ranks * c.update_queue_capacity,
            lc_queue_capacity=ranks * c.lc_queue_capacity,
            zero_queue_capacity=ranks * c.zero_queue_capacity)
    if kind == "restir":
        return RenderConfig(**kw, integrator="restir"), ReSTIRConfig()
    return RenderConfig(**kw, denoise=True), None


def phase37(dev, smi, n=RANKS, backend="gloo", frames=None):
    """Row slabs: dryrun_multichip(n) on the card, then the sharded city
    frames of n ranks (MCPG 4 frames at two queue capacities, ReSTIR and
    denoised PT 1 frame each; ``frames`` of each when given), against the
    single-device frames on ``dev``. Rank r runs on card r mod the cards
    there are: with one card (gloo), all n share it."""
    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.parallel.render import (
        dryrun_multichip, queue_gather_bytes, spawn_ranks,
    )
    from merian_quake_tpu_torch.render import layout
    from merian_quake_tpu_torch.renderer import frame_core, init_state

    cards = torch.cuda.device_count()
    how = (f"{n} {backend} ranks sharing one card, not a multi-GPU time" if cards == 1
           else f"{n} {backend} ranks on {min(n, cards)} cards")
    # none of these frames reads the slabs' flat buffers end to end (SSMM
    # does), so slabs that do not tile as the image does are allowed
    tiles = layout.is_tiled(W, H // n)
    t0 = time.perf_counter()
    dry = dryrun_multichip(n, device=dev, backend=backend)
    log(f"phase 37 dryrun_multichip({n}, cuda) [{smi}; {how}]: "
        f"{time.perf_counter() - t0:.1f} s, ldr {tuple(dry['ldr'].shape)} finite, replicas "
        f"bit-equal, {dry['live_states']} live states; {H // n}-row slabs "
        f"{'tile' if tiles else 'do not tile'}")

    bundle = city(device=dev)
    acc = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    paths, stats = {}, {}
    runs = (("mcpg", SHARD_FRAMES, {"woop_nearest": 3}),
            ("mcpg_wide", SHARD_FRAMES, {"woop_nearest": 3}),
            ("restir", 1, {"woop_nearest": 2, "woop_any": 1}),
            ("pt_denoise", 1, {"woop_nearest": 1 + SPP * (MPL - 1)}))
    for kind, k_frames, expect in runs:
        count = k_frames if frames is None else frames
        t0 = time.perf_counter()
        ranks = spawn_ranks(n, _shard_rank, kind, count, backend=backend, device=dev,
                            timeout_s=900)
        secs = time.perf_counter() - t0
        for r, o in enumerate(ranks):
            for i, got in enumerate(o["launches"]):
                if got != {**{k: 0 for k in got}, **expect}:
                    raise AssertionError(f"{kind} rank {r} frame {i}: launched {got}, expected "
                                         f"{expect}")
        paths[f"{kind}_{n}ranks"] = {k: sum(f[k] for o in ranks for f in o["launches"])
                                   for k in ranks[0]["launches"][0]}
        ldr = torch.cat([o["ldr"] for o in ranks])
        hdr = torch.cat([o["hdr"] for o in ranks])
        if tuple(ldr.shape) != (H, W, 3) or not bool(torch.isfinite(ldr).all()) \
                or not bool(torch.isfinite(hdr).all()):
            raise AssertionError(f"the sharded {kind} frame is not a finite 1080p image")
        # the single-device frames on the card, from the same empty state
        config, icfg = shard_config(kind, feats, n)
        state = init_state(config, icfg, device=dev)
        single_ms = []
        for i in range(count):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, out = frame_core(acc, bundle.atlas, bundle.uniforms._replace(frame=i), config,
                                    state, mcpg_config=icfg)
            torch.cuda.synchronize()
            single_ms.append((time.perf_counter() - t1) * 1e3)
            if i == 0:
                ldr0 = out["ldr"].cpu()
        read = {"single_device_ms": single_ms, "ldr_max": float((ldr - out["ldr"].cpu()).abs().max()),
                "hdr_max": float((hdr - out["hdr"].cpu()).abs().max()),
                "frame0_ldr_max": float((torch.cat([o["ldr0"] for o in ranks]) - ldr0)
                                        .abs().max())}
        if kind.startswith("mcpg"):
            for key in ("mc_f", "mc_i", "lc_irr", "lc_hash", "lc_n"):
                if any(not torch.equal(o[key], ranks[0][key]) for o in ranks[1:]):
                    raise AssertionError(f"the sharded MCPG frame: replica {key} differs")
            read["sum_w_max"] = float((ranks[0]["mc_f"][:, 3] - state.mcpg.mc.f[:, 3].cpu())
                                      .abs().max())
            read["lc_irr_max"] = float((ranks[0]["lc_irr"] - state.mcpg.lc.irr.cpu()).abs().max())
            read["live_states"] = int((ranks[0]["mc_f"][:, 3] > 0).sum())
            read["gather_bytes"] = [o["gather_bytes"] for o in ranks]
            read["queue_gather_bytes"] = queue_gather_bytes(config, icfg, n)
            # a slab keeps capacity / n rows of each queue: where a slab's
            # live rows pass that, it drops other rows than the single
            # device, which keeps the first rows of the whole image
            caps = (icfg.update_queue_capacity // n, icfg.lc_queue_capacity // n,
                    icfg.zero_queue_capacity // n)
            read["live_rows_by_rank"] = [o["live_rows"][-1] for o in ranks]
            read["slab_capacities"] = caps
            overflow = any(n > c for o in ranks for f in o["live_rows"] for n, c in zip(f, caps))
            read["a_slab_overflows"] = overflow
            held = read["frame0_ldr_max"] <= 3e-5
            if not overflow:
                held = held and read["ldr_max"] <= 3e-5 and read["sum_w_max"] <= 1e-5 \
                    and read["lc_irr_max"] <= 1e-5
            # the main path's capacities may overflow a slab (then frame 0,
            # before any guiding, is what must agree); the wide capacities
            # must not
            ok = held and not (kind == "mcpg_wide" and overflow)
        elif kind == "restir":
            ok = read["ldr_max"] <= 3e-5
        else:
            d = (ldr - out["ldr"].cpu()).abs()
            read["svgf_irr_max"] = float((torch.cat([o["svgf_irr"] for o in ranks])
                                          - state.svgf.irr.cpu()).abs().max())
            read["ldr_share_over_1e-3"] = float((d > 1e-3).float().mean())
            ok = read["hdr_max"] <= 1e-4 and read["svgf_irr_max"] <= 1e-5 \
                and read["ldr_share_over_1e-3"] < 0.02 and read["ldr_max"] < 0.1
        ms = [o["ms"] for o in ranks]
        steady = [float(np.mean(m[1:])) if len(m) > 1 else m[0] for m in ms]
        stats[kind] = {"rank_ms": ms, "steady_ms": steady, "spawn_to_end_s": secs, **read}
        log(f"phase 37 sharded {kind} city {W}x{H} spp {SPP} mpl {MPL} x{count} frames "
            f"[{smi}; {how}]: ms/frame by rank "
            f"{[[round(x, 1) for x in m] for m in ms]}; launches a rank a frame {expect}; "
            f"against the single-device frame on the card {read}; {secs:.1f} s")
        if not ok:
            raise AssertionError(f"the sharded {kind} frame disagrees with the single-device "
                                 f"frame: {read}")
    return paths, stats
