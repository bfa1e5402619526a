"""Row-slab rendering over several devices (``torch.distributed``).

Port of merian_quake_tpu/parallel/render.py. Each rank renders image rows
[rank·rows, (rank+1)·rows): ray generation, intersection, shading and
accumulation are independent per pixel. A frame's communication is the
exposure's mean log luminance (``all_reduce``, the JAX package's
``lax.pmean``), the guiding-update queues (``all_gather``, then every
rank replays the same rows into its replica of the guiding state), and
the halo exchanges and gathered images of ReSTIR, SSMM, the volume pass
and the denoise chain (post/sharded.py; ``ppermute`` → point-to-point
sends to the neighbour ranks). RNG streams use absolute pixel
coordinates, so a slab's integrator output is the single-device output's
rows; the exposure mean and the denoise chain agree within the JAX
package's tolerances (PARITY.md §2.6).

A mesh is a process group, made by the caller with the backend of its
choice: NCCL for one card a rank, gloo for CPU ranks and for ranks that
share one card (NCCL refuses two ranks on one device). Nothing changes
the backend or the device on its own. ``spawn_ranks`` starts n ranks on
one host with a ``file://`` rendezvous (no network), and
``dryrun_multichip`` renders one sharded MCPG frame through it.

The slabs' flat buffers laid end to end are the whole image's flat
buffer where both tile alike (render/layout.py: width % 128 == 0 and
rows % 8 == 0, or neither tiles): SSMM's lane roll depends on it. At
1920×1080, 360-row slabs (3 ranks) tile; 540 and 270 do not.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..models.types import RenderConfig
from ..post.sharded import ShardCtx
from ..renderer import FrameState, frame_core, init_state


class Mesh(NamedTuple):
    """This process's place in a row-slab mesh: one rank of ``size``, on
    ``device``, over the process group ``group`` (None: the default)."""

    rank: int
    size: int
    backend: str
    device: torch.device
    group: object = None


def make_mesh(device="cuda", group=None) -> Mesh:
    """The mesh of an initialised process group (``dist.init_process_group``
    with the backend, address, world size and rank given by the caller)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    return Mesh(rank=dist.get_rank(group), size=dist.get_world_size(group),
                backend=dist.get_backend(group), device=torch.device(device), group=group)


def queue_gather_bytes(config, mcfg, n_devices: int) -> dict:
    """A frame's guiding-queue gather volume in bytes across ``n_devices``
    slabs: 'dense' gathers every queue row of every slab (update 15 + lc
    10 + zero 2 i32 columns × M rows, + dist 5 × M_vol); 'compact' the
    per-slab class-sorted live prefixes the frame gathers (update 16 ×
    capu/n, lc 7 × capl/n, zeros capz/n, dist 6 × capdist/n)."""
    from ..render.mcpg import MCPGConfig
    from ..render.mcpg.volume import DIST_QUEUE_CAPACITY

    H, W = config.height, config.width
    m_surf = H * W * max(config.spp, 1) * max(config.max_path_length - 1, 1)
    vspp = mcfg.volume.volume_spp if mcfg is not None and mcfg.volume is not None else 0
    m_vol = H * W * vspp
    m = m_surf + m_vol
    dense = 4 * ((15 + 10 + 2) * m + 5 * m_vol)
    mcfg = MCPGConfig() if mcfg is None else mcfg
    n = max(n_devices, 1)
    capu = min(m, max(mcfg.update_queue_capacity // n, 1024))
    capl = min(m, max(mcfg.lc_queue_capacity // n, 1024))
    capz = min(m, max(mcfg.zero_queue_capacity // n, 256))
    capd = min(m_vol, max(DIST_QUEUE_CAPACITY // n, 256)) if m_vol else 0
    compact = 4 * n * (16 * capu + 7 * capl + capz + 6 * capd)
    return {
        "queue_rows": m,
        "dense_bytes": dense * n,  # every device receives the full set
        "compact_bytes": compact,
        "reduction": round(dense * n / max(compact, 1), 2),
    }


def _slab_state(state: FrameState, y0: int, rows: int, width: int) -> FrameState:
    """A whole-image state's part for the slab [y0, y0 + rows): per-pixel
    images and flat per-pixel buffers (ReSTIR, SSMM) keep the slab's rows;
    the guiding state (MCPG chains, light cache, the volume's distance
    grid) stays whole on every rank, a replica."""
    img = lambda x: None if x is None else x[y0 : y0 + rows].contiguous()
    flat = lambda x: x[y0 * width : (y0 + rows) * width].contiguous()
    each = lambda t, f: None if t is None else type(t)(*[f(x) for x in t])
    vol = state.volume
    if vol is not None:
        vol = vol._replace(volume_depth=img(vol.volume_depth),
                           prev_volume_depth=img(vol.prev_volume_depth))
    restir = state.restir
    if restir is not None:
        restir = restir._replace(reservoirs=each(restir.reservoirs, flat),
                                 prev_normal=flat(restir.prev_normal),
                                 prev_linear_z=flat(restir.prev_linear_z))
    return state._replace(
        accum_irradiance=img(state.accum_irradiance), accum_direct=img(state.accum_direct),
        accum_albedo=img(state.accum_albedo), volume=vol, accum_volume=img(state.accum_volume),
        accum_volume_len=img(state.accum_volume_len), restir=restir,
        ssmm=each(state.ssmm, flat), svgf=each(state.svgf, img), taa_prev=img(state.taa_prev),
        volume_svgf=each(state.volume_svgf, img),
    )


def init_state_sharded(mesh: Mesh, config: RenderConfig, mcpg_config=None) -> FrameState:
    """This rank's part of ``init_state``: its slab of the images, a
    replica of the guiding state."""
    n = mesh.size
    assert config.height % n == 0, (config.height, n)
    rows = config.height // n
    state = init_state(config, mcpg_config, device=mesh.device)
    return _slab_state(state, mesh.rank * rows, rows, config.width)


def regroup(g, groups: int = 1):
    """Every slab's queue rows (n, M_slab, ...), flattened as (group,
    pixel) with ``groups`` groups a slab, in the whole image's order:
    group-major, the slabs' pixels of a group in slab order (the JAX
    package's ``gather_all``). At ``groups`` = 1, which every gather of
    the frame uses (the queues are compacted per slab and carry their
    global row ids), it is the slabs' rows end to end."""
    ndev, per = g.shape[0], g.shape[1] // groups
    g = g.reshape((ndev, groups, per) + tuple(g.shape[2:]))
    return g.transpose(0, 1).reshape((-1,) + tuple(g.shape[3:]))


def render_frame_sharded(mesh: Mesh, accel, atlas, uniforms, config, state,
                         mcpg_config=None, schedule=None):
    """One frame of this rank's slab. Returns (new_state, ldr slab, hdr
    slab). For MCPG every slab's compacted update queues are gathered and
    every rank replays the whole set into its replica of the guiding
    state. ``hdr`` is the pre-FXAA beauty (FXAA's discrete edge branches
    turn f32 reassociation into local flips)."""
    n = mesh.size
    assert config.height % n == 0, (config.height, n)
    rows = config.height // n
    ctx = ShardCtx.for_group(rows, config.height, mesh.group)
    new_state, outputs = frame_core(
        accel, atlas, uniforms, config, state, mcpg_config=mcpg_config, schedule=schedule,
        y0=ctx.y0, rows=rows, mean_fn=ctx.mean,
        gather_fn=lambda x, groups=1: regroup(ctx.all_gather(x), groups), shard_ctx=ctx,
    )
    return new_state, outputs["ldr"], outputs["hdr"]


def _rank_main(rank, n, backend, device, init_file, timeout_s, fn, args, results):
    try:
        torch.set_num_threads(1)  # n ranks share the host's cores
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=n,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(make_mesh(dev), *args)
        finally:
            dist.destroy_process_group()
        # plain pickle: the tensors travel as bytes, not as shared memory
        # that the rank's exit would take away
        results.put((rank, True, pickle.dumps(out)))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(n: int, fn, *args, backend: str = "gloo", device="cuda",
                timeout_s: float = 900.0):
    """Run ``fn(mesh, *args)`` on n ranks of one host (spawned processes,
    rendezvous through a ``file://`` in a temporary directory) and return
    the ranks' results in rank order; each rank runs torch on one thread.
    ``fn`` must be importable at module level and its results picklable.
    ``device="cuda"``: rank r on card r mod the cards there are;
    ``backend``: "gloo" or "nccl", the caller's choice. A failure on any
    rank raises with its traceback; every process is stopped before this
    returns."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(r, n, backend, device, init_file, timeout_s,
                                                      fn, args, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        got, errors = {}, []
        deadline = time.monotonic() + timeout_s + 60.0
        try:
            while len(got) + len(errors) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    errors.append(f"timed out after {timeout_s + 60.0:.0f} s")
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 5.0))
                except queue.Empty:  # see whether a rank died without a word
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead and len(got) + len(errors) < n:
                        errors.append(f"rank process exited with {dead[0].exitcode}")
                        break
                    continue
                if ok:
                    got[rank] = pickle.loads(out)
                else:
                    errors.append(f"rank {rank}:\n{out}")
                    break
        finally:
            for p in procs:
                p.join(timeout=30.0)
                if p.is_alive():
                    p.terminate()
                    p.join()
    if errors:
        raise RuntimeError("a rank failed: " + "\n".join(errors))
    return [got[r] for r in range(n)]


def _dryrun_rank(mesh: Mesh, height_per_rank: int):
    """One sharded MCPG frame of the cornell box on this rank (the JAX
    package's ``_dryrun_multichip_inproc``): checks the slab and returns
    what the parent compares across ranks."""
    from ..accel.build import build_accel, scene_features
    from ..models.procedural import cornell_box
    from ..render.mcpg import MCPGConfig

    bundle = cornell_box(device=mesh.device)
    accel = build_accel(bundle.scene, bundle.atlas, device=mesh.device)
    height = height_per_rank * mesh.size
    config = RenderConfig(
        width=32, height=height, spp=1, max_path_length=2, integrator="mcpg",
        features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas),
    )
    mcfg = MCPGConfig(mc_adaptive_size=1 << 12, mc_static_size=1 << 10, lc_size=1 << 12)
    state = init_state_sharded(mesh, config, mcfg)
    new_state, ldr, _ = render_frame_sharded(
        mesh, accel, bundle.atlas, bundle.uniforms, config, state, mcfg
    )
    assert ldr.shape == (height_per_rank, 32, 3), ldr.shape
    assert bool(torch.isfinite(ldr).all())
    assert new_state.iteration == 1
    mc = new_state.mcpg.mc
    assert bool(torch.isfinite(mc.f).all())
    return {
        "ldr": ldr.cpu(),
        "mc_f": mc.f.cpu(), "mc_i": mc.i.cpu(),
        "lc_irr": new_state.mcpg.lc.irr.cpu(), "lc_hash": new_state.mcpg.lc.hash.cpu(),
    }


def dryrun_multichip(n_devices: int, device="cuda", backend: str = "gloo") -> dict:
    """Render ONE sharded MCPG frame on ``n_devices`` ranks (the JAX
    package's ``__graft_entry__.dryrun_multichip``): the pixel grid split
    into row slabs, the update queues gathered and replayed on every
    rank, the exposure mean all-reduced. Checks that every slab is finite
    and that the replicas of the guiding state are bit-equal across
    ranks; returns the stitched LDR image, the live states and the
    per-frame queue gather volume of the bench's configuration."""
    from ..render.mcpg.config import production_config

    outs = spawn_ranks(n_devices, _dryrun_rank, 8, backend=backend, device=device)
    for r, o in enumerate(outs[1:], 1):
        for k in ("mc_f", "mc_i", "lc_irr", "lc_hash"):
            if not torch.equal(o[k], outs[0][k]):
                raise AssertionError(f"replica {k} of rank {r} differs from rank 0's")
    bench = RenderConfig(width=1920, height=1080, spp=2, max_path_length=3, integrator="mcpg")
    return {
        "ldr": torch.cat([o["ldr"] for o in outs]),
        "live_states": int((outs[0]["mc_f"][:, 3] > 0).sum()),
        "gather_bytes": queue_gather_bytes(bench, production_config(), n_devices),
    }
