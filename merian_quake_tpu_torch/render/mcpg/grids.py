"""MC hash-grid addressing, state load/finalize, vMF lobe derivation.

Port of merian_quake_tpu/render/mcpg/grids.py:
- adaptive grid: camera-distance-scaled exponential level with stochastic
  level offset (-log2(1-u)) and stochastic trilinear cell jitter, normal
  bucket in the hash,
- static grid: fixed-width cells, hemisphere check on load,
- 16-bit verification hash → collision resets the state,
- temporal target reprojection w_tgt += sum_w·(cl_time - T)·mv,
- vMF lobe: direction to weighted target, kappa from regularized mean
  cosine with a distance-based ML prior.

``gather_rows`` is the plain row index. Slots, ids and hashes are u32
values in int64 tensors (ops/hashgrid.py). A cell of any of the three
hash grids (the adaptive and the static guide grid, the light cache) is
:func:`cell`: on CUDA tensors one launch of csrc/u32_chains.cu, on CPU
tensors its plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...kernels import F, I64, INT, P, check, entry, f32, f32_recip, launch
from ...ops import hashgrid, linalg, rng as rng_ops, vmf
from ...ops.rng import _M32
from .config import MCPGConfig, MCStates


class StateSample(NamedTuple):
    """A gathered MCState per ray (all tensors [...])."""

    id: torch.Tensor  # u32 value (int64)
    w_tgt: torch.Tensor  # [..., 3]
    sum_w: torch.Tensor
    w_cos: torch.Tensor
    mv: torch.Tensor  # [..., 3]
    T: torch.Tensor
    N: torch.Tensor  # i32
    hash: torch.Tensor  # u32 value (int64)


def new_state(rng_state):
    """A fresh chain with a random id."""
    rng_state, u = rng_ops.uniform(rng_state)
    shape = tuple(u.shape)
    dev = u.device
    z3 = torch.zeros(shape + (3,), device=dev)
    z = torch.zeros(shape, device=dev)
    # u · 2^32 (the f32 nearest 4294967295) is an integer of at most 2^32:
    # the conversion to u32 saturates there, written out
    uid = torch.clamp_max((u * 4294967295.0).to(torch.int64), _M32)
    return rng_state, StateSample(
        id=uid,
        w_tgt=z3,
        sum_w=z,
        w_cos=z,
        mv=z3,
        T=z,
        N=torch.zeros(shape, dtype=torch.int32, device=dev),
        hash=torch.zeros(shape, dtype=torch.int64, device=dev),
    )


def state_pos(s: StateSample) -> torch.Tensor:
    return torch.where(
        (s.sum_w > 0.0)[..., None],
        s.w_tgt / torch.where(s.sum_w == 0.0, 1.0, s.sum_w)[..., None],
        s.w_tgt,
    )


def state_dir(s: StateSample, pos: torch.Tensor) -> torch.Tensor:
    return linalg.normalize(state_pos(s) - pos)


def state_prior(s: StateSample, pos: torch.Tensor, cfg: MCPGConfig) -> torch.Tensor:
    d2 = torch.square(pos - state_pos(s)).sum(-1)
    return torch.clamp_min(cfg.dir_guide_prior / torch.clamp_min(d2, 1e-12), 1e-4)


def state_mean_cos(s: StateSample, pos, cfg: MCPGConfig) -> torch.Tensor:
    n2 = (s.N * s.N).to(torch.float32)
    r = torch.clamp(s.w_cos / torch.where(s.sum_w == 0.0, 1.0, s.sum_w), 0.0, 0.9999999)
    return n2 * r / (n2 + state_prior(s, pos, cfg))


def state_vmf(s: StateSample, pos, cfg: MCPGConfig):
    """Returns (mu [...,3], kappa [...])."""
    mu = state_dir(s, pos)
    kappa = torch.clamp_max(
        vmf.kappa_from_mean_cos(state_mean_cos(s, pos, cfg)), cfg.kappa_max
    )
    return mu, kappa


def light_missing(s: StateSample, mc_f, wo, pos, cfg: MCPGConfig):
    """Learned light vanished?"""
    big_f = mc_f > 1e-3 * s.sum_w
    cos = linalg.dot(wo, state_dir(s, pos))
    aligned = cos >= 0.9 + 0.1 * state_mean_cos(s, pos, cfg)
    return (~big_f) & aligned


# ---------------- adaptive grid addressing ----------------


def _adaptive_width_for_level(level, cfg: MCPGConfig):
    return cfg.mc_adaptive_min_width * torch.pow(
        cfg.mc_adaptive_power, level / cfg.mc_adaptive_steps_per_unit
    )


def adaptive_target_level(pos, cam_x, cfg: MCPGConfig):
    width = 2.0 * cfg.mc_adaptive_tan_alpha_half * linalg.distance(cam_x, pos)
    return torch.round(
        cfg.mc_adaptive_steps_per_unit
        * torch.log(
            torch.clamp_min(width, cfg.mc_adaptive_min_width) / cfg.mc_adaptive_min_width
        )
        / _log_f32(cfg.mc_adaptive_power)
    )


@functools.lru_cache(maxsize=64)
def _log_f32(x: float) -> float:
    """log of a config constant as the f32 value the JAX package's f32
    graph divides by (a Python double would divide by another number).
    Computed once a value: a frame reads no tensor on the host for it."""
    return float(torch.log(torch.tensor(x, dtype=torch.float32)))


def _lc_width_for_level(level, cfg: MCPGConfig):
    return cfg.lc_min_width * torch.pow(cfg.lc_power, level / cfg.lc_steps_per_unit)


def adaptive_cell(rng_state, pos, normal, cam_x, cfg: MCPGConfig, target_level=None):
    """Stochastic adaptive cell for pos: (rng, buffer_index, hash16).

    ``target_level`` may be precomputed (it is deterministic in pos) and
    reused across the K state draws — the stochastic level offset and
    trilinear jitter still differ per draw."""
    return cell(rng_state, pos, cfg, "adaptive", normal=normal, cam_x=cam_x, level=target_level)


def static_cell(rng_state, pos, cfg: MCPGConfig):
    """Static cell: (rng, buffer_index [offset past adaptive], hash16)."""
    return cell(rng_state, pos, cfg, "static")


def adaptive_cell_reference(rng_state, pos, normal, cam_x, cfg: MCPGConfig, target_level=None):
    """The torch path of :func:`adaptive_cell`."""
    rng_state, u_level = rng_ops.uniform_reference(rng_state)
    if target_level is None:
        target_level = adaptive_target_level(pos, cam_x, cfg)
    level = target_level + torch.floor(-torch.log2(torch.clamp_min(1.0 - u_level, 1e-7)))
    level = level.to(torch.int32)
    rng_state, u3 = rng_ops.uniforms_reference(rng_state, 3)
    idx = hashgrid.grid_idx_interpolate(
        pos, _adaptive_width_for_level(level.to(torch.float32), cfg)[..., None], u3
    )
    buf = hashgrid.hash_grid_normal_level(
        idx, normal, level, cfg.mc_adaptive_size, tile_bits=cfg.grid_tile_bits
    )
    h = hashgrid.hash2_grid_level(idx, level)
    return rng_state, buf, h


def static_cell_reference(rng_state, pos, cfg: MCPGConfig):
    """The torch path of :func:`static_cell`."""
    rng_state, u3 = rng_ops.uniforms_reference(rng_state, 3)
    idx = hashgrid.grid_idx_interpolate(pos, cfg.mc_static_width, u3)
    buf = (
        hashgrid.hash_grid(idx, cfg.mc_static_size, tile_bits=cfg.grid_tile_bits)
        + cfg.mc_adaptive_size
    ) & _M32
    h = hashgrid.hash2_grid(idx)
    return rng_state, buf, h


def light_cache_cell_reference(rng_state, pos, normal, level, cfg: MCPGConfig):
    """The light cache's cell at a (float) level: (rng, buffer_index,
    hash16), the torch path."""
    rng_state, u3 = rng_ops.uniforms_reference(rng_state, 3)
    idx = hashgrid.grid_idx_interpolate(
        pos, _lc_width_for_level(level, cfg)[..., None], u3
    )
    lvl = level.to(torch.int32)
    buf = hashgrid.hash_grid_normal_level(
        idx, normal, lvl, cfg.lc_size, tile_bits=cfg.grid_tile_bits
    )
    h = hashgrid.hash2_grid_level(idx, lvl)
    return rng_state, buf, h


GRIDS = ("adaptive", "static", "light_cache")


def cell_reference(rng_state, pos, cfg: MCPGConfig, grid: str, normal=None, cam_x=None,
                   level=None):
    """The torch path of :func:`cell`: the plain version of
    csrc/u32_chains.cu's mq_grid_cell."""
    if grid == "adaptive":
        return adaptive_cell_reference(rng_state, pos, normal, cam_x, cfg, target_level=level)
    if grid == "static":
        return static_cell_reference(rng_state, pos, cfg)
    return light_cache_cell_reference(rng_state, pos, normal, level, cfg)


@functools.lru_cache(maxsize=64)
def level_scale(cfg: MCPGConfig, grid: str) -> tuple:
    """The adaptive grid's or the light cache's level scale as torch rounds
    it on the card, csrc/hash_grid.cuh's Level: (tan2, min_w, inv_min_w,
    steps, inv_steps, inv_log_p, power)."""
    pre = {"adaptive": "mc_adaptive_", "light_cache": "lc_"}[grid]
    tan, min_w, steps, power = (getattr(cfg, pre + k) for k in
                                ("tan_alpha_half", "min_width", "steps_per_unit", "power"))
    return (f32(2.0 * tan), f32(min_w), f32_recip(min_w), f32(steps), f32_recip(steps),
            f32_recip(_log_f32(power)), f32(power))


@functools.lru_cache(maxsize=64)
def _cell_constants(cfg: MCPGConfig, grid: str) -> tuple:
    """mq_grid_cell's level scale, inv_width, size and offset for a grid."""
    if grid == "static":
        return (0.0,) * 7, f32_recip(cfg.mc_static_width), cfg.mc_static_size, cfg.mc_adaptive_size
    size = cfg.mc_adaptive_size if grid == "adaptive" else cfg.lc_size
    return level_scale(cfg, grid), 0.0, size, 0


def check_lanes(name, x, n, dev, cols=None, dtype=torch.float32):
    """Raise unless ``x`` is ``dtype`` [n] (contiguous) or, with ``cols``,
    [n, cols] at any strides, on ``dev``."""
    shape = (n,) if cols is None else (n, cols)
    check(name, x, dtype, shape, dev, contiguous=cols is None)


# rng, pos and its strides, normal and its strides, cam_x, level, n, grid,
# the level scale, inv_width, size, offset, tile_bits, the 3 outputs and
# the stream
_CELL_ARGS = ((P, P, I64, I64, P, I64, I64, P, P, I64, INT) + (F,) * 8
              + (ctypes.c_uint, ctypes.c_uint, INT) + (P,) * 4)


def cell(rng_state, pos, cfg: MCPGConfig, grid: str, normal=None, cam_x=None, level=None):
    """The cell of each lane's position on one hash grid, with its draws:
    (rng, buffer_index, hash16), u32 values in int64[n] each.

    ``grid``: "adaptive" (needs ``normal`` and, unless ``level`` gives the
    target level, ``cam_x``), "static" or "light_cache" (``normal`` and a
    float ``level``). rng_state: int64[n]; pos, normal: f32[n,
    3] at any strides; cam_x f32[3]; level f32[n].

    On CUDA tensors one launch of csrc/u32_chains.cu, its outputs new and
    nothing synchronized, counted in ``cell.launches``; on CPU tensors
    :func:`cell_reference`. Raises on another grid, dtype, shape, device
    or layout."""
    if grid not in GRIDS:
        raise ValueError(f"grid {grid!r}: one of {GRIDS}")
    n = rng_state.shape[0] if rng_state.dim() == 1 else -1
    dev = rng_state.device
    check_lanes("rng_state", rng_state, n, dev, dtype=torch.int64)
    check_lanes("pos", pos, n, dev, cols=3)
    if grid != "static":
        check_lanes("normal", normal, n, dev, cols=3)
        if level is not None or grid == "light_cache":
            check_lanes("level", level, n, dev)
        else:
            check("cam_x", cam_x, torch.float32, (3,), dev)
    if dev.type == "cpu":
        return cell_reference(rng_state, pos, cfg, grid, normal=normal, cam_x=cam_x, level=level)
    scale, inv_width, size, offset = _cell_constants(cfg, grid)
    rng_out, buf, h = (torch.empty(n, dtype=torch.int64, device=dev) for _ in range(3))
    if n:
        static = grid == "static"
        launch(entry("u32_chains", "mq_grid_cell", _CELL_ARGS), dev,
               rng_state.data_ptr(), pos.data_ptr(), *pos.stride(),
               None if static else normal.data_ptr(), *((0, 0) if static else normal.stride()),
               None if static or level is not None else cam_x.data_ptr(),
               None if level is None else level.data_ptr(), n, GRIDS.index(grid), *scale,
               inv_width, size, offset, cfg.grid_tile_bits, rng_out.data_ptr(), buf.data_ptr(),
               h.data_ptr())
        cell.launches += 1
    return rng_out, buf, h


cell.launches = 0


def gather_rows(tab: torch.Tensor, idx) -> torch.Tensor:
    """Row gather."""
    return tab[idx.to(torch.int64)]


def gather_state(mc: MCStates, idx) -> StateSample:
    """Two packed gathers instead of 8 per-field gathers."""
    gf = gather_rows(mc.f, idx)
    gi = gather_rows(mc.i, idx)
    return StateSample(
        id=gi[..., 0].to(torch.int64) & _M32,
        w_tgt=gf[..., 0:3],
        sum_w=gf[..., 3],
        w_cos=gf[..., 4],
        mv=gf[..., 5:8],
        T=gf[..., 8],
        N=gi[..., 1],
        hash=gi[..., 2].to(torch.int64) & _M32,
    )


def pack_states_draw(mc: MCStates, cl_time) -> torch.Tensor:
    """(S, 8) i32 STATE-DRAW table with the temporal target reprojection
    (w_tgt += sum_w·(cl_time−T)·mv) PRE-APPLIED over the whole table once
    per frame instead of per gathered row per draw. Rows that a load
    later finds invalid (hash mismatch / hemisphere) keep the reprojected
    w_tgt — harmless: finalize zeroes their sum_w, so they carry zero
    reservoir score and zero MIS weight. Tombstoned rows (sum_w < 0) are
    NOT reprojected (the clamp below). Columns: [w_tgt(3), sum_w, w_cos
    (f32 bits), id, N, hash]."""
    w_tgt = (
        mc.f[:, 0:3]
        + (torch.clamp_min(mc.f[:, 3], 0.0) * (cl_time - mc.f[:, 8]))[:, None] * mc.f[:, 5:8]
    )
    return torch.cat(
        [w_tgt.contiguous().view(torch.int32), mc.f[:, 3:5].contiguous().view(torch.int32), mc.i],
        dim=1,
    )


def gather_state_packed_draw(packed: torch.Tensor, idx) -> StateSample:
    """gather against a pack_states_draw table. mv/T come back ZERO, so
    finalize_load's reprojection is a structural no-op (already applied
    table-side); the winner threads id/N/sum_w/w_cos/w_tgt onward —
    exactly the fields the update/fast-recovery paths read."""
    g = gather_rows(packed, idx)
    gf = g[..., 0:5].contiguous().view(torch.float32)
    z3 = torch.zeros(tuple(gf.shape[:-1]) + (3,), device=g.device)
    return StateSample(
        id=g[..., 5].to(torch.int64) & _M32,
        w_tgt=gf[..., 0:3],
        sum_w=gf[..., 3],
        w_cos=gf[..., 4],
        mv=z3,
        T=torch.zeros(tuple(gf.shape[:-1]), device=g.device),
        N=g[..., 6],
        hash=g[..., 7].to(torch.int64) & _M32,
    )


def pack_sample(st: StateSample):
    """StateSample (per-ray) → packed (M, 9) f32 + (M, 3) i32 rows."""
    f = torch.cat(
        [st.w_tgt, st.sum_w[..., None], st.w_cos[..., None], st.mv, st.T[..., None]],
        dim=-1,
    )
    i = torch.stack(
        [hashgrid.u32_to_i32(st.id), st.N.to(torch.int32), hashgrid.u32_to_i32(st.hash)],
        dim=-1,
    )
    return f, i


def finalize_load(
    s: StateSample,
    expected_hash,
    cl_time,
    pos=None,
    normal=None,
    hemisphere_check: bool = False,
) -> StateSample:
    """Collision/validity reset + temporal target reprojection.

    When fed a ``pack_states_draw`` table (whose reprojection is
    pre-applied) the static-grid hemisphere check evaluates the direction
    toward the REPROJECTED w_tgt, and hash-mismatch rows keep the
    reprojected w_tgt. Harmless: those rows carry sum_w = 0 → zero
    reservoir score and zero MIS weight."""
    invalid = (s.sum_w < 0.0) | (s.hash != expected_hash)
    if hemisphere_check:
        invalid = invalid | (linalg.dot(normal, state_dir(s, pos)) <= 0.0)
    sum_w = torch.where(invalid, 0.0, s.sum_w)
    w_tgt = s.w_tgt + (sum_w * (cl_time - s.T))[..., None] * s.mv
    return s._replace(sum_w=sum_w, w_tgt=w_tgt)
