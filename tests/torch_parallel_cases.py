"""Cases of the port's row-slab frame (parallel/render.py) for the
tests/test_torch_parallel*.py files: each case's settings, the ranks'
side (``rank_cases``, run in ``spawn_ranks``'s gloo processes on the
CPU, one thread a rank, one process group a test file), the single-device
references of both packages, and the stitching of the slabs.

A case is (scene, RenderConfig keywords, integrator config, frames,
options). Options: ``force_gather`` (ReSTIR's gather route), the mutants
``local_gather`` (every rank replays only its own queue rows) and
``edge_halo`` (halos replicate the slab's own edge rows instead of
receiving the neighbour's).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from merian_quake_tpu_torch.post.sharded import ShardCtx

RANKS = 4

# the JAX package's tests/test_parallel.py configurations, at heights that
# give every rank of RANKS the slab the case needs
SMALL_MCPG = dict(mc_adaptive_size=1 << 12, mc_static_size=1 << 10, lc_size=1 << 12)
FOG = dict(mu_t=0.004, mu_s=(0.0032,) * 3)
CASES = {
    # test_sharded_matches_single_device
    "pt": dict(cfg=dict(width=48, height=32, spp=1, max_path_length=3), frames=1),
    # test_sharded_denoise_matches_single_device: 8-row slabs, so that the
    # à-trous steps 1, 2 and 4 read halos and 8 and 16 the gathered image
    "denoise": dict(cfg=dict(width=48, height=32, spp=1, max_path_length=2, denoise=True),
                    frames=3),
    "denoise_edge_halo": dict(cfg=dict(width=48, height=32, spp=1, max_path_length=2,
                                       denoise=True), frames=3, edge_halo=True),
    # test_sharded_mcpg_matches_single_device
    "mcpg": dict(cfg=dict(width=48, height=16, spp=1, max_path_length=2, integrator="mcpg"),
                 mcfg=SMALL_MCPG, frames=2),
    "mcpg_local_gather": dict(cfg=dict(width=48, height=16, spp=1, max_path_length=2,
                                       integrator="mcpg"), mcfg=SMALL_MCPG, frames=2,
                              local_gather=True),
    # a width that tiles (render/layout.py): 8-row slabs of a 256-wide
    # image, laid out tile-major like the whole image
    "mcpg_tiled": dict(cfg=dict(width=256, height=32, spp=1, max_path_length=2,
                                integrator="mcpg"), mcfg=SMALL_MCPG, frames=2),
    # test_sharded_mcpg_volume_matches_single_device
    "mcpg_volume": dict(cfg=dict(width=48, height=16, spp=1, max_path_length=2,
                                 integrator="mcpg"), mcfg=SMALL_MCPG,
                        volume=dict(volume_spp=2, dist_guide_p=0.5), fog=FOG, frames=2),
    # test_restir_halo_matches_gather_and_single_device: 16-row slabs,
    # radius 4 (a halo of 16 rows)
    "restir_halo": dict(cfg=dict(width=48, height=64, spp=1, integrator="restir"),
                        rcfg=dict(spatial_reuse_iterations=2, temporal_bias_correction=1,
                                  spatial_bias_correction=1, spatial_radius=4.0), frames=2),
    "restir_gather": dict(cfg=dict(width=48, height=64, spp=1, integrator="restir"),
                          rcfg=dict(spatial_reuse_iterations=2, temporal_bias_correction=1,
                                    spatial_bias_correction=1, spatial_radius=4.0), frames=2,
                          force_gather=True),
    # test_sharded_ssmm_matches_single_device
    "ssmm": dict(cfg=dict(width=48, height=32, spp=2, integrator="ssmm"), frames=3),
}


def _port_setup(case, device="cpu"):
    """(bundle, accel, config, integrator config) of the port."""
    from merian_quake_tpu_torch.accel.build import build_accel, scene_features
    from merian_quake_tpu_torch.models.procedural import cornell_box
    from merian_quake_tpu_torch.models.types import RenderConfig

    bundle = cornell_box(device=device)
    if "fog" in case:
        f3 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        bundle = bundle._replace(uniforms=bundle.uniforms._replace(
            mu_t=f3(case["fog"]["mu_t"]), mu_s=f3(case["fog"]["mu_s"])))
    accel = build_accel(bundle.scene, bundle.atlas, device=device)
    config = RenderConfig(**case["cfg"], features=scene_features(
        bundle.scene, bundle.uniforms, bundle.atlas))
    return bundle, accel, config, _port_icfg(case)


def _port_icfg(case):
    if "mcfg" in case:
        from merian_quake_tpu_torch.render.mcpg import MCPGConfig
        from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig

        vol = VolumeConfig(**case["volume"]) if "volume" in case else None
        return MCPGConfig(**case["mcfg"], volume=vol)
    if "rcfg" in case:
        from merian_quake_tpu_torch.render.restir import ReSTIRConfig

        return ReSTIRConfig(**case["rcfg"])
    if case["cfg"].get("integrator") == "ssmm":
        from merian_quake_tpu_torch.render.ssmm import SSMMConfig

        return SSMMConfig()
    return None


def _collect(state, ldr, hdr):
    """What a case compares, as numpy: images (slabs), the flat
    per-pixel buffers and the replicated guiding state."""
    out = {"ldr": ldr, "hdr": hdr, "accum_irradiance": state.accum_irradiance}
    if state.svgf is not None:
        out["svgf_irr"] = state.svgf.irr
        out["svgf_hist"] = state.svgf.history_len
    if state.mcpg is not None:
        mc, lc = state.mcpg.mc, state.mcpg.lc
        out.update(mc_f=mc.f, mc_i=mc.i, lc_irr=lc.irr, lc_hash=lc.hash, lc_n=lc.N)
    if state.volume is not None:
        d = state.volume.dist_mc
        out.update(dist_sum_w=d.sum_w, dist_n=d.N, dist_moments=d.moments,
                   volume_depth=state.volume.volume_depth, accum_volume=state.accum_volume)
    if state.restir is not None:
        out["restir_w"] = state.restir.reservoirs.w
        out["restir_m"] = state.restir.reservoirs.M
    if state.ssmm is not None:
        out["ssmm_sum_w"] = state.ssmm.sum_w
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


class EdgeHaloCtx(ShardCtx):
    """Mutant: a halo of the slab's own edge rows (no exchange)."""

    def halo_pad(self, x, r):
        return torch.cat([x[:1].expand((r,) + tuple(x.shape[1:])), x,
                          x[-1:].expand((r,) + tuple(x.shape[1:]))], 0)


def _rank_case(mesh, case):
    from merian_quake_tpu_torch import renderer
    from merian_quake_tpu_torch.parallel import render as par
    from merian_quake_tpu_torch.render import restir as restir_pkg

    bundle, accel, config, icfg = _port_setup(case, mesh.device)
    state = par.init_state_sharded(mesh, config, icfg)
    rows = config.height // mesh.size
    ctx = ShardCtx.for_group(rows, config.height, mesh.group)
    if case.get("edge_halo"):
        ctx = EdgeHaloCtx(*ctx)
    gather = (lambda x, groups=1: x) if case.get("local_gather") else (
        lambda x, groups=1: par.regroup(ctx.all_gather(x), groups))
    mutant = case.get("edge_halo") or case.get("local_gather")
    orig = restir_pkg.render_restir
    if case.get("force_gather"):
        restir_pkg.render_restir = functools.partial(orig, force_gather=True)
    try:
        u = bundle.uniforms
        for i in range(case["frames"]):
            u = u._replace(frame=i)
            if mutant:
                state, out = renderer.frame_core(
                    accel, bundle.atlas, u, config, state, mcpg_config=icfg, y0=ctx.y0,
                    rows=rows, mean_fn=ctx.mean, gather_fn=gather, shard_ctx=ctx,
                )
                ldr, hdr = out["ldr"], out["hdr"]
            else:
                state, ldr, hdr = par.render_frame_sharded(
                    mesh, accel, bundle.atlas, u, config, state, icfg)
    finally:
        restir_pkg.render_restir = orig
    return _collect(state, ldr, hdr)


def _rank_collectives(mesh):
    """ShardCtx's exchanges on known values: this rank's 6-row slab of a
    (6·ranks)×5×2 image (values ±(10·global row + column)), a halo of 2,
    the flat roll, the gathers and the mean of the ranks' numbers."""
    rows, width = 6, 5
    ctx = ShardCtx.for_group(rows, rows * mesh.size, mesh.group)
    y = torch.arange(rows, dtype=torch.float32)[:, None] + ctx.y0
    x = torch.arange(width, dtype=torch.float32)[None, :]
    img = torch.stack([y * 10 + x, -(y * 10 + x)], -1)
    flat = img.reshape(rows * width, 2)
    return {k: v.numpy() for k, v in {
        "halo": ctx.halo_pad(img, 2), "roll": ctx.roll1(flat), "rows": ctx.gather_rows(img),
        "flat": ctx.gather_flat(flat, width), "mean": ctx.mean(torch.tensor(float(mesh.rank))),
    }.items()}


def rank_cases(mesh, names):
    """The ranks' side: every named case on this rank's slab."""
    return {name: _rank_collectives(mesh) if name == "collectives" else _rank_case(
        mesh, CASES[name]) for name in names}


def sharded_runs(names):
    """Spawn RANKS gloo ranks on the CPU once and run every case there;
    returns {case: [rank 0's results, ...]}."""
    from merian_quake_tpu_torch.parallel.render import spawn_ranks

    outs = spawn_ranks(RANKS, rank_cases, tuple(names), device="cpu", timeout_s=600)
    return {name: [o[name] for o in outs] for name in names}


def port_single(name):
    """The port's single-device frames of a case (CPU)."""
    from merian_quake_tpu_torch.renderer import init_state, render_frame

    case = CASES[name]
    bundle, accel, config, icfg = _port_setup(case)
    state = init_state(config, icfg, device="cpu")
    u = bundle.uniforms
    for i in range(case["frames"]):
        u = u._replace(frame=i)
        state, out = render_frame(accel, bundle.atlas, u, config, state, icfg)
    return _collect(state, out["ldr"], out["hdr"])


def jax_single(name, jit=True):
    """The JAX package's single-device frames of a case: jitted, or op by
    op (``jax.disable_jit``; where its jitted run spreads from itself,
    the port follows this one)."""
    import contextlib

    import jax
    import jax.numpy as jnp

    from merian_quake_tpu.accel.build import build_accel, scene_features
    from merian_quake_tpu.models.procedural import cornell_box
    from merian_quake_tpu.models.types import RenderConfig
    from merian_quake_tpu.renderer import init_state, render_frame

    case = CASES[name]
    bundle = cornell_box()
    if "fog" in case:
        bundle = bundle._replace(uniforms=bundle.uniforms._replace(
            mu_t=jnp.float32(case["fog"]["mu_t"]), mu_s=jnp.asarray(case["fog"]["mu_s"],
                                                                     jnp.float32)))
    accel = build_accel(bundle.scene, bundle.atlas)
    config = RenderConfig(**case["cfg"], features=scene_features(
        bundle.scene, bundle.uniforms, bundle.atlas))
    icfg = None
    if "mcfg" in case:
        from merian_quake_tpu.render.mcpg import MCPGConfig
        from merian_quake_tpu.render.mcpg.volume import VolumeConfig

        vol = VolumeConfig(**case["volume"]) if "volume" in case else None
        icfg = MCPGConfig(**case["mcfg"], volume=vol)
    elif "rcfg" in case:
        from merian_quake_tpu.render.restir import ReSTIRConfig

        icfg = ReSTIRConfig(**case["rcfg"])
    elif case["cfg"].get("integrator") == "ssmm":
        from merian_quake_tpu.render.ssmm import SSMMConfig

        icfg = SSMMConfig()
    state = init_state(config, icfg)
    u = bundle.uniforms
    with contextlib.nullcontext() if jit else jax.disable_jit():
        for i in range(case["frames"]):
            u = u._replace(frame=jnp.uint32(i))
            state, out = render_frame(accel, bundle.atlas, u, config, state, icfg)
    res = {"ldr": out["ldr"], "hdr": out["hdr"], "accum_irradiance": state.accum_irradiance}
    if state.svgf is not None:
        res.update(svgf_irr=state.svgf.irr, svgf_hist=state.svgf.history_len)
    if state.mcpg is not None:
        res.update(mc_f=state.mcpg.mc.f, mc_i=state.mcpg.mc.i, lc_irr=state.mcpg.lc.irr)
    if state.volume is not None:
        res.update(dist_sum_w=state.volume.dist_mc.sum_w,
                   volume_depth=state.volume.volume_depth, accum_volume=state.accum_volume)
    if state.restir is not None:
        res.update(restir_w=state.restir.reservoirs.w)
    if state.ssmm is not None:
        res.update(ssmm_sum_w=state.ssmm.sum_w)
    return {k: np.asarray(v) for k, v in res.items()}


def stitch(parts, key, width=None):
    """The whole image of an image key (slabs end to end), or of a flat
    per-pixel buffer (each slab's flat layout → image rows; ``width``)."""
    if width is None:
        return np.concatenate([p[key] for p in parts])
    from merian_quake_tpu_torch.render import layout

    imgs = []
    for p in parts:
        x = torch.from_numpy(p[key])
        rows = x.shape[0] // width
        imgs.append(layout.flat_to_image(x, width, rows).numpy())
    return np.concatenate(imgs)


def flat_image(x, width, height):
    """A whole image's flat buffer as an image."""
    from merian_quake_tpu_torch.render import layout

    return layout.flat_to_image(torch.from_numpy(np.array(x)), width, height).numpy()


def reading(ours, ref):
    """(share of pixels whose channels are all within 1e-3, mean |Δ|)."""
    d = np.abs(np.asarray(ours, np.float64) - np.asarray(ref, np.float64))
    per = d.reshape(d.shape[0] * d.shape[1], -1).max(-1) if d.ndim > 2 else d.reshape(-1)
    return float((per <= 1e-3).mean()), float(d.mean())


def assert_within(ours, ref, share, mean):
    got = reading(ours, ref)
    assert got[0] >= share and got[1] <= mean, (got, (share, mean))


def assert_replicas(parts, keys):
    """The replicated state is bit-equal on every rank."""
    for r, p in enumerate(parts[1:], 1):
        for k in keys:
            assert np.array_equal(p[k].view(np.uint8), parts[0][k].view(np.uint8)), (k, r)


MCPG_REPLICAS = ("mc_f", "mc_i", "lc_irr", "lc_hash", "lc_n")


def mcpg_bound(parts, ref, rtol=0.0):
    """tests/test_parallel.py's MCPG tolerances: ldr 3e-5, ``mc`` sum_w and
    ``lc.irr`` 1e-5 (sum_w also ``rtol`` relative)."""
    np.testing.assert_allclose(stitch(parts, "ldr"), ref["ldr"], atol=3e-5)
    np.testing.assert_allclose(parts[0]["mc_f"][:, 3], np.asarray(ref["mc_f"])[:, 3],
                               atol=1e-5, rtol=rtol)
    np.testing.assert_allclose(parts[0]["lc_irr"], ref["lc_irr"], atol=1e-5)
