"""The SVGF kernels (csrc/svgf.cu) against the torch SVGF (40)."""
from __future__ import annotations

import numpy as np
import torch

from .common import H, HBM_RATE, W, cuda_time, leaf_diff, log


SVGF_SOURCE = "merian_quake_tpu_torch/csrc/svgf.cu"
SVGF_REPLACES = ("no TPU kernel: the port's torch SVGF (post/svgf.py temporal_reference and "
                 "atrous_iteration_reference); the JAX package's is jnp code")
# frames of seeded inputs on one geometry: the first with every history
# invalid, then histories growing past 4 where the reprojection holds
SVGF_FRAMES = 5
# f32 bytes a pixel each kernel must move: the temporal step reads the
# frame's irradiance and moment (16, one f32[H, W, 4] as the renderer slices
# it), mv 8, normal 12, depth 4, its gradients 8 and the history's 10
# channels (40), and writes irr 12, moments 8, history_len 4 and the two
# records 32; a pass reads the records (32) and the gradients (8) and
# writes a record (16), the last one reading the albedo (16, a slice of an
# f32[H, W, 4]) and writing rgb (12)
SVGF_BYTES = {"temporal": 16 + 8 + 12 + 4 + 8 + 40 + 12 + 8 + 4 + 32, "atrous": 32 + 8 + 16,
              "atrous_last": 32 + 8 + 16 + 12}


def svgf_geometry(dev, h, w):
    """Normals and linear depth with edges (a normal flip, two depth planes,
    a step), depth gradients and albedo at h×w, seeded, on ``dev``."""
    r = np.random.default_rng(40)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    n = np.zeros((h, w, 3), np.float32)
    n[..., 2] = 1.0
    n[:, w // 2:] = [1.0, 0.0, 0.0]
    n[h // 3: h // 2, : w // 3] = [0.0, 0.0, -1.0]
    n += r.normal(0, 0.05, n.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    z = np.where(xx < w // 3, 10.0 + 0.01 * yy, 40.0 + 0.02 * xx).astype(np.float32)
    z[h // 4: h // 4 + 16] += 25.0
    zg = r.normal(0, 0.05, (h, w, 2)).astype(np.float32)
    alb = r.uniform(-0.1, 1.0, (h, w, 4)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return {"normal": t(n), "linear_z": t(z), "z_grad": t(zg), "albedo": t(alb)}


def svgf_frame(dev, h, w, seed):
    """A frame's irradiance and second moment (f32[h, w, 4], sliced as the
    renderer slices it, with a flat block) and motion vectors: sub-pixel
    drift, a band pointing off the left edge, rows off the bottom, a block
    of NaN and one of inf."""
    r = np.random.default_rng(seed)
    irr = r.gamma(1.0, 0.5, (h, w, 4)).astype(np.float32)
    irr[h // 8: h // 4, w // 8: w // 4, :3] = 0.5
    mv = r.normal(0, 0.6, (h, w, 2)).astype(np.float32)
    mv[:, : w // 16, 0] = -3e3
    mv[h // 2: h // 2 + 8, :, 1] = 1e5
    mv[-8:, -8:] = np.nan
    mv[:8, -8:] = np.inf
    t = lambda a: torch.from_numpy(a).to(dev)
    return t(irr), t(mv)


def svgf_torch(state, irr, moments_in, mv, normal, linear_z, z_grad, albedo, params=None):
    """svgf's torch path on any device: temporal_reference, the passes of
    atrous_iteration_reference, the albedo."""
    from merian_quake_tpu_torch.post import svgf as sv

    params = params or sv.SVGFParams()
    new_state, i, v = sv.temporal_reference(state, irr, moments_in, mv, normal, linear_z, z_grad,
                                            params)
    for k in range(params.iterations):
        i, v = sv.atrous_iteration_reference(i, v, normal, linear_z, z_grad, 1 << k, params)
    return new_state, i * torch.clamp_min(albedo, 0.0)


def svgf_random(dev, h, w, smi):
    """SVGF_FRAMES frames of seeded inputs at h×w: the kernels (svgf on the
    card) against the torch path, each state leaf, the records of the
    temporal step and of each pass, and the output. Returns {leaf: worst
    (differ, abs, rel)} and the last frame's inputs and state."""
    from merian_quake_tpu_torch.post import svgf as sv

    geo_in = svgf_geometry(dev, h, w)
    P = sv.SVGFParams()
    state = sv.init_svgf_state(h, w, device=dev)
    worst = {}
    for f in range(SVGF_FRAMES):
        irr4, mv = svgf_frame(dev, h, w, 400 + f)
        args = (irr4[..., :3], irr4[..., 3], mv, geo_in["normal"], geo_in["linear_z"],
                geo_in["z_grad"])
        st_k, out_k = sv.svgf(state, *args, geo_in["albedo"][..., :3], P)
        st_t, out_t = svgf_torch(state, *args, geo_in["albedo"][..., :3], P)
        # the records, pass by pass
        _, rec, geo = sv.svgf_temporal(state, *args, P)
        _, ii, vv = sv.temporal_reference(state, *args, P)
        got = {"rgb": out_k, "irr": st_k.irr, "moments": st_k.moments,
               "history_len": st_k.history_len, "temporal rec irr": rec[..., :3],
               "temporal rec variance": rec[..., 3]}
        ref = {"rgb": out_t, "irr": st_t.irr, "moments": st_t.moments,
               "history_len": st_t.history_len, "temporal rec irr": ii, "temporal rec variance": vv}
        for k in range(P.iterations):
            rec = sv.svgf_atrous(rec, geo, geo_in["z_grad"], 1 << k, P)
            ii, vv = sv.atrous_iteration_reference(ii, vv, geo_in["normal"], geo_in["linear_z"],
                                                   geo_in["z_grad"], 1 << k, P)
            got[f"pass {k} irr"], got[f"pass {k} variance"] = rec[..., :3], rec[..., 3]
            ref[f"pass {k} irr"], ref[f"pass {k} variance"] = ii, vv
        valid = float((st_t.history_len > 1).float().mean())
        res = leaf_diff(f"{h}x{w} frame {f} (history valid on {valid:.4f} of the pixels, "
                        f"history_len up to {float(st_t.history_len.max()):.0f})", got, ref)
        for k, v in res.items():
            worst[k] = max(worst.get(k, (0, 0.0, 0.0)), v)
        state = st_t
    return worst, (args, geo_in, state)


def svgf_slab(dev, h, w, rows, y0, step, smi):
    """A halo-padded row slab as svgf_sharded passes it to atrous_iteration
    (interior borders: the neighbours' true rows; the image's border: the
    edge row repeated): the kernel's dispatch against the torch path on the
    slab, and the cropped result against the whole image's rows."""
    from merian_quake_tpu_torch.post import svgf as sv

    g = svgf_geometry(dev, h, w)
    irr4, _ = svgf_frame(dev, h, w, 77)
    var = irr4[..., 3].contiguous()
    r = 2 * step
    rows_of = lambda x: x[torch.clamp(torch.arange(y0 - r, y0 + rows + r, device=dev), 0, h - 1)]
    slab = [rows_of(x) for x in (irr4[..., :3], var, g["normal"], g["linear_z"], g["z_grad"])]
    P = sv.SVGFParams()
    ki, kv = sv.atrous_iteration(*slab, step, P)
    ti, tv = sv.atrous_iteration_reference(*slab, step, P)
    fi, fv = sv.atrous_iteration(irr4[..., :3], var, g["normal"], g["linear_z"], g["z_grad"],
                                 step, P)
    a = leaf_diff(f"slab rows {y0}-{y0 + rows} of {h}x{w} with a {r}-row halo, step {step}",
                  {"irr": ki, "variance": kv}, {"irr": ti, "variance": tv})
    b = leaf_diff(f"slab rows {y0}-{y0 + rows} cropped against the whole image's rows",
                  {"irr": ki[r:-r], "variance": kv[r:-r]},
                  {"irr": fi[y0: y0 + rows], "variance": fv[y0: y0 + rows]})
    return {f"slab {k}": v for k, v in a.items()} | {f"slab crop {k}": v for k, v in b.items()}


def svgf_captured(dev, smi):
    """A captured city ReSTIR frame with denoise: the launches of the SVGF
    kernels the capture records into the graph (one surface SVGF: 1 + 5),
    then 6 replays against eager frame_core with the SVGF on the torch path,
    from the same state: every state leaf and output. Returns ({leaf:
    (differ, abs, rel)}, launches in the graph)."""
    from merian_quake_tpu_torch.accel import build_accel
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.capture import WARMUP_STEPS, tree_leaves, tree_map
    from merian_quake_tpu_torch.models.procedural import city
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.post import svgf as sv
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.renderer import compile_frame, frame_core, init_state

    bundle = city(device=dev)
    accel = build_accel(bundle.scene, bundle.atlas)
    feats = scene_features(bundle.scene, bundle.uniforms, bundle.atlas)
    cfg = RenderConfig(width=W, height=H, integrator="restir", denoise=True, features=feats)
    icfg = ReSTIRConfig()
    state0 = init_state(cfg, icfg, device=dev)
    cf = compile_frame(accel, bundle.atlas, cfg, state0, icfg)
    sv.svgf_temporal.launches = sv.svgf_atrous.launches = 0
    st, out = cf(bundle.uniforms._replace(frame=0))
    torch.cuda.synchronize()
    counts = (sv.svgf_temporal.launches, sv.svgf_atrous.launches)
    if any(c % (WARMUP_STEPS + 1) for c in counts):
        raise AssertionError(f"phase 40: SVGF launches {counts} over the warm-up and the capture")
    in_graph = [c // (WARMUP_STEPS + 1) for c in counts]
    if in_graph != [1, 5]:
        raise AssertionError(f"phase 40: a captured surface SVGF records {in_graph} launches "
                             "(temporal, passes), expected [1, 5]")
    plain = sv.svgf
    worst, clone = {}, lambda x: tree_map(torch.clone, x)
    try:
        for i in range(1, 7):
            u = bundle.uniforms._replace(frame=i)
            ref_in = clone(st)
            sv.svgf = svgf_torch
            try:
                ref_st, ref_out = frame_core(accel, bundle.atlas, u, cfg, ref_in, mcpg_config=icfg)
            finally:
                sv.svgf = plain
            st, out = cf(u)
            got = {f"state {k}": x for k, x in enumerate(tree_leaves(st))}
            got |= {f"out {k}": x for k, x in enumerate(tree_leaves(out))}
            ref = {f"state {k}": x for k, x in enumerate(tree_leaves(ref_st))}
            ref |= {f"out {k}": x for k, x in enumerate(tree_leaves(ref_out))}
            res = leaf_diff(f"captured city ReSTIR frame {i} against eager with the torch SVGF",
                            got, ref)
            for k, v in res.items():
                worst[k] = max(worst.get(k, (0, 0.0, 0.0)), v)
            del ref_in, ref_st, ref_out
    finally:
        sv.svgf = plain
    svgf_leaves = {"svgf irr": st.svgf.irr, "svgf moments": st.svgf.moments,
                   "svgf history_len": st.svgf.history_len}
    log(f"phase 40 captured city ReSTIR + denoise [{smi}]: launches in the graph: temporal "
        f"{in_graph[0]}, passes {in_graph[1]}; the last frame's history_len up to "
        f"{float(svgf_leaves['svgf history_len'].max()):.0f}")
    return worst, sum(in_graph)


def svgf_timing(dev, args, geo_in, state, smi):
    """Each kernel alone at 1080p by CUDA events against its bound (bytes /
    3.35 TB/s) and the torch path it replaces; the whole SVGF, kernels
    against the torch path."""
    from merian_quake_tpu_torch.post import svgf as sv

    P = sv.SVGFParams()
    h, w = args[0].shape[:2]
    px = h * w
    alb = geo_in["albedo"][..., :3]
    _, rec, geo = sv.svgf_temporal(state, *args, P)
    bound = lambda k: px * SVGF_BYTES[k] / HBM_RATE * 1e3
    t = {"temporal": (cuda_time(lambda: sv.svgf_temporal(state, *args, P), 20),
                      cuda_time(lambda: sv.temporal_reference(state, *args, P), 3),
                      bound("temporal"))}
    ii, vv = rec[..., :3].contiguous(), rec[..., 3].contiguous()
    for k in range(P.iterations):
        step = 1 << k
        t[f"atrous step {step}"] = (
            cuda_time(lambda: sv.svgf_atrous(rec, geo, geo_in["z_grad"], step, P), 20),
            cuda_time(lambda: sv.atrous_iteration_reference(ii, vv, geo_in["normal"],
                                                            geo_in["linear_z"],
                                                            geo_in["z_grad"], step, P), 3),
            bound("atrous"))
    t["atrous last (step 16, albedo)"] = (
        cuda_time(lambda: sv.svgf_atrous(rec, geo, geo_in["z_grad"], 16, P, albedo=alb), 20),
        None, bound("atrous_last"))
    k1 = cuda_time(lambda: sv.svgf(state, *args, alb, P), 10)
    r1 = cuda_time(lambda: svgf_torch(state, *args, alb, P), 3)
    k2 = cuda_time(lambda: sv.svgf(state, *args, alb, P), 10)
    r2 = cuda_time(lambda: svgf_torch(state, *args, alb, P), 3)
    whole_bound = bound("temporal") + 4 * bound("atrous") + bound("atrous_last")
    for name, (ms, plain, b) in t.items():
        log(f"phase 40 timing {name} {w}x{h} [{smi}]: kernel {ms:.4f} ms, bound {b:.4f} ms "
            f"(bytes), {100 * b / ms:.1f}% of it" + (f"; torch path {plain:.3f} ms" if plain
                                                    else ""))
    log(f"phase 40 timing the whole surface SVGF {w}x{h} [{smi}]: kernels {k1:.4f} / {k2:.4f} "
        f"ms, torch path {r1:.3f} / {r2:.3f} ms (in turns); bound {whole_bound:.4f} ms (bytes)")
    return {"ms": (k1 + k2) / 2, "plain_ms": (r1 + r2) / 2, "bound_ms": whole_bound,
            "bound_by": "bytes", "by_kernel": {k: {"ms": v[0], "plain_ms": v[1], "bound_ms": v[2]}
                                               for k, v in t.items()}}


def phase40(dev, smi):
    """The SVGF kernels (csrc/svgf.cu): against svgf's torch path on the
    card on seeded 1080p inputs (a first frame with every history invalid,
    motion vectors off-screen and non-finite, normal and depth edges), on a
    37x53 image (step 16 reaching past both borders), on halo-padded row
    slabs as svgf_sharded passes them, and on a captured city ReSTIR frame
    with denoise (6 replays against eager frame_core with the torch SVGF,
    every state leaf and output; the launches the capture records); then
    each kernel timed alone against its bound, and the whole SVGF against
    the torch path. Returns the readings."""
    worst, (args, geo_in, state) = svgf_random(dev, H, W, smi)
    small, _ = svgf_random(dev, 37, 53, smi)
    slabs = {}
    for rows, y0, step in ((64, 0, 1), (64, 512, 4), (64, H - 64, 16), (40, 520, 16)):
        slabs |= svgf_slab(dev, H, W, rows, y0, step, smi)
    captured, in_graph = svgf_captured(dev, smi)
    every = {**{f"1080p {k}": v for k, v in worst.items()},
             **{f"37x53 {k}": v for k, v in small.items()}, **slabs,
             **{f"captured {k}": v for k, v in captured.items()}}
    bad = {k: v for k, v in every.items() if v[0]}
    if bad:
        raise AssertionError(f"phase 40: the kernels differ from the torch path: {bad}")
    timing = svgf_timing(dev, args, geo_in, state, smi)
    log(f"phase 40 the SVGF kernels [{smi}]: bit for bit against the torch path on "
        f"{len(every)} leaves; {in_graph} launches a captured surface SVGF")
    return {**timing, "launches_in_graph": in_graph, "leaves_compared": len(every),
            "max_abs_err": 0.0}
