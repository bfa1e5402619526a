"""Carry host arrays into the port's containers.

Each ``*_from_numpy`` takes a container of the JAX package's layout (a
NamedTuple with the same field names, holding anything ``np.asarray``
reads: numpy arrays, JAX arrays, lists) and returns the port's
container with every tensor on ``device``. Nothing here imports JAX:
a JAX array is read through ``np.asarray`` like any other array.

Types follow the port's conventions: u32 values (octahedral codes,
reservoir flags, the uniforms' ``frame`` and ``player``) become int64
tensors or Python ints, bfloat16 stays bfloat16 (through float32, which
holds every bfloat16 value exactly).
"""
from __future__ import annotations

import numpy as np
import torch

from .models.types import Scene, TextureAtlas, Uniforms


def tensor(x, device="cuda") -> torch.Tensor:
    """One array as a tensor on ``device``: u32 → int64, bfloat16 kept.
    The data is copied: the tensor never shares the caller's buffer."""
    a = np.array(x, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def scene_from_numpy(scene, device="cuda") -> Scene:
    return Scene(*[tensor(getattr(scene, f), device) for f in Scene._fields])


def atlas_from_numpy(atlas, device="cuda") -> TextureAtlas:
    return TextureAtlas(
        data=tensor(atlas.data, device),
        table=tensor(atlas.table, device),
        mips=tuple(tensor(m, device) for m in atlas.mips),
        flat=None if atlas.flat is None else tensor(atlas.flat, device),
    )


def uniforms_from_numpy(uniforms, device="cuda") -> Uniforms:
    as_int = ("frame", "player")
    return Uniforms(**{
        f: int(np.asarray(getattr(uniforms, f))) if f in as_int
        else tensor(getattr(uniforms, f), device)
        for f in Uniforms._fields
    })


def gbuffer_from_numpy(gbuf, device="cuda"):
    from .render.gbuffer import GBufferOutput
    from .render.hit import CompressedHit

    hits = CompressedHit(*[tensor(getattr(gbuf.hits, f), device) for f in CompressedHit._fields])
    return GBufferOutput(**{
        f: hits if f == "hits" else tensor(getattr(gbuf, f), device)
        for f in GBufferOutput._fields
    })


def restir_state_from_numpy(state, device="cuda"):
    from .render.restir import ReSTIRState
    from .render.restir.reservoir import Reservoir

    res = Reservoir(*[tensor(getattr(state.reservoirs, f), device) for f in Reservoir._fields])
    return ReSTIRState(
        reservoirs=res,
        prev_normal=tensor(state.prev_normal, device),
        prev_linear_z=tensor(state.prev_linear_z, device),
    )


def mcpg_state_from_numpy(state, device="cuda"):
    """The guiding state carried across frames: both chain tables, the
    light cache (its 16-bit hash as int32) and the two counters (0-d
    int64)."""
    from .render.mcpg.config import LightCache, MCPGState, MCStates

    return MCPGState(
        mc=MCStates(f=tensor(state.mc.f, device), i=tensor(state.mc.i, device)),
        lc=LightCache(
            hash=tensor(state.lc.hash, device).to(torch.int32),
            irr=tensor(state.lc.irr, device),
            N=tensor(state.lc.N, device),
        ),
        lc_updates_applied=tensor(state.lc_updates_applied, device),
        lc_updates_merged=tensor(state.lc_updates_merged, device),
    )


def volume_state_from_numpy(state, device="cuda"):
    """The volume pass's state: the distance-MC grid and the expected
    scatter depths."""
    from .render.mcpg.volume import DistanceMC, VolumeState

    return VolumeState(
        dist_mc=DistanceMC(*[tensor(getattr(state.dist_mc, f), device) for f in DistanceMC._fields]),
        volume_depth=tensor(state.volume_depth, device),
        prev_volume_depth=tensor(state.prev_volume_depth, device),
    )


def surface_result_from_numpy(result, device="cuda"):
    """A guided surface (or volume) pass's result with its queues, so
    that a replay takes the JAX package's own emission."""
    from .render.mcpg.surface import DistQueue, LCQueue, SurfaceResult, UpdateQueue, ZeroQueue

    opt = lambda x: None if x is None else tensor(x, device)
    dist = getattr(result, "dist", None)
    return SurfaceResult(
        irradiance=tensor(result.irradiance, device),
        updates=UpdateQueue(data=tensor(result.updates.data, device)),
        lc_samples=LCQueue(*[tensor(getattr(result.lc_samples, f), device) for f in LCQueue._fields]),
        zeros=ZeroQueue(*[tensor(getattr(result.zeros, f), device) for f in ZeroQueue._fields]),
        dist=None if dist is None else DistQueue(data=tensor(dist.data, device)),
        live_in=opt(getattr(result, "live_in", None)),
        gidx=opt(getattr(result, "gidx", None)),
    )


def svgf_state_from_numpy(state, device="cuda"):
    """An SVGF history (irradiance, moments, history length, normals,
    depth)."""
    from .post.svgf import SVGFState

    return SVGFState(*[tensor(getattr(state, f), device) for f in SVGFState._fields])


def ssmm_state_from_numpy(state, device="cuda"):
    """The SSMM chains, one a pixel in flat buffer order (``N`` int32)."""
    from .render.ssmm import SSMMState

    return SSMMState(*[tensor(getattr(state, f), device) for f in SSMMState._fields])


def frame_state_from_numpy(state, device="cuda"):
    """The accumulators, the frame count and, where present, the ReSTIR,
    the MCPG and the SSMM state, the volume's state and history, and the
    denoiser's histories (both SVGF states and the TAA's previous LDR)
    of a frame state."""
    from .renderer import FrameState

    get = lambda f: getattr(state, f, None)
    opt = lambda x: None if x is None else tensor(x, device)
    opt_with = lambda fn, x: None if x is None else fn(x, device)
    return FrameState(
        accum_irradiance=tensor(state.accum_irradiance, device),
        accum_direct=tensor(state.accum_direct, device),
        accum_albedo=tensor(state.accum_albedo, device),
        iteration=int(np.asarray(state.iteration)),
        restir=opt_with(restir_state_from_numpy, get("restir")),
        mcpg=opt_with(mcpg_state_from_numpy, get("mcpg")),
        volume=opt_with(volume_state_from_numpy, get("volume")),
        accum_volume=opt(get("accum_volume")),
        accum_volume_len=opt(get("accum_volume_len")),
        ssmm=opt_with(ssmm_state_from_numpy, get("ssmm")),
        svgf=opt_with(svgf_state_from_numpy, get("svgf")),
        taa_prev=opt(get("taa_prev")),
        volume_svgf=opt_with(svgf_state_from_numpy, get("volume_svgf")),
    )
