"""Light cache: adaptive hash grid of EWA irradiance estimates.

Port of merian_quake_tpu/render/mcpg/light_cache.py: one EWA step per
cell per frame, from the MEAN of the frame's samples for that cell.
Hash-mismatch cells are re-initialized from one coarser level. A lookup
(:func:`lookup`) is one launch of csrc/u32_chains.cu on CUDA tensors.
"""
from __future__ import annotations

import ctypes

import torch

from ...kernels import F, I64, INT, P, check, entry, launch
from ...ops import linalg, rng as rng_ops, segments
from ...ops.hashgrid import u32_to_i32
from ...ops.rng import _M32
from .config import LightCache, MCPGConfig
from . import grids
from .grids import _log_f32, gather_rows


def pack_f16_pair(a, b):
    """Two f32 columns, clipped to [0, 6e4], as an f16 pair in one i32
    lane (round to nearest even)."""

    def u16(x):
        h = torch.clamp(x, 0.0, 6e4).to(torch.float16).contiguous()
        return h.view(torch.int16).to(torch.int64) & 0xFFFF

    return u32_to_i32(u16(a) | (u16(b) << 16))


def unpack_f16_pair(p):
    p = p.to(torch.int64) & _M32

    def f16(x):
        # 16 bits → int16 with the same bits → f16
        return ((x ^ 0x8000) - 0x8000).to(torch.int16).view(torch.float16).to(torch.float32)

    return f16(p & 0xFFFF), f16(p >> 16)


def _pack_lc(lc: LightCache) -> torch.Tensor:
    """(L, 5) i32 table [hash, irr(3 bitcast), N]: ONE row-gather per
    lookup instead of three."""
    return torch.cat(
        [
            lc.hash.to(torch.int32)[:, None],
            lc.irr.contiguous().view(torch.int32),
            lc.N[:, None],
        ],
        dim=1,
    )


def _lc_level(pos, cam_x, cfg: MCPGConfig):
    width = 2.0 * cfg.lc_tan_alpha_half * linalg.distance(cam_x, pos)
    return torch.round(
        cfg.lc_steps_per_unit
        * torch.log(torch.clamp_min(width, cfg.lc_min_width) / cfg.lc_min_width)
        / _log_f32(cfg.lc_power)
    )


def _lc_cell(rng_state, pos, normal, level, cfg: MCPGConfig):
    return grids.cell(rng_state, pos, cfg, "light_cache", normal=normal, level=level)


def lookup_reference(rng_state, table, pos, normal, cfg: MCPGConfig, cam_x=None, level=None,
                     dead=None):
    """The torch path of :func:`lookup`: the plain version of
    csrc/u32_chains.cu's mq_lc_lookup."""
    if level is None:
        level = _lc_level(pos, cam_x, cfg)
    rng_state, buf, h = grids.cell_reference(rng_state, pos, cfg, "light_cache", normal=normal,
                                             level=level)
    idx = buf
    if dead is not None:
        # dead lanes read row 0 (result discarded by the caller)
        idx = torch.where(dead, 0, idx)
    rows = gather_rows(table, idx)  # (..., 5)
    stored_h = rows[..., 0].to(torch.int64) & _M32
    irr = rows[..., 1:4].contiguous().view(torch.float32)
    n = rows[..., 4]
    ok = (stored_h == h) & torch.isfinite(irr).all(-1)
    return rng_state, torch.where(ok[..., None], irr, 0.0), torch.where(ok, n, 0)


# rng, pos and its strides, normal and its strides, cam_x, level, dead,
# table, n, the level scale, size, tile_bits, the 3 outputs and the stream
_LOOKUP_ARGS = ((P, P, I64, I64, P, I64, I64, P, P, P, P, I64) + (F,) * 7
                + (ctypes.c_uint, INT) + (P,) * 4)


def lookup(rng_state, table, pos, normal, cfg: MCPGConfig, cam_x=None, level=None, dead=None):
    """The light cache's cell of each lane and its row of ``table`` (the
    i32[lc_size, 5] ``_pack_lc``): (rng, irradiance f32[n, 3], N i32[n]),
    zero where the row's hash is another cell's or its irradiance is not
    finite. The cell's level is ``level`` (f32[n]) or, without it, the
    level at pos seen from ``cam_x`` (f32[3]). rng_state: int64[n]; pos,
    normal: f32[n, 3] at any strides; dead: None or bool[n] (such lanes
    read row 0).

    On CUDA tensors one launch of csrc/u32_chains.cu, its outputs new and
    nothing synchronized, counted in ``lookup.launches``; on CPU tensors
    :func:`lookup_reference`. Raises on another dtype, shape, device or
    layout, and on a tiled layout whose slots can pass the table."""
    n = rng_state.shape[0] if rng_state.dim() == 1 else -1
    dev = rng_state.device
    grids.check_lanes("rng_state", rng_state, n, dev, dtype=torch.int64)
    grids.check_lanes("pos", pos, n, dev, cols=3)
    grids.check_lanes("normal", normal, n, dev, cols=3)
    if level is not None:
        grids.check_lanes("level", level, n, dev)
    else:
        check("cam_x", cam_x, torch.float32, (3,), dev)
    if dead is not None:
        grids.check_lanes("dead", dead, n, dev, dtype=torch.bool)
    check("table", table, torch.int32, (cfg.lc_size, 5), dev)
    if cfg.grid_tile_bits and cfg.lc_size < 1 << (3 * cfg.grid_tile_bits):
        raise ValueError(f"lc_size {cfg.lc_size} is smaller than a tile of grid_tile_bits "
                         f"{cfg.grid_tile_bits}: slots would pass the table")
    if dev.type == "cpu":
        return lookup_reference(rng_state, table, pos, normal, cfg, cam_x=cam_x, level=level,
                                dead=dead)
    rng_out = torch.empty(n, dtype=torch.int64, device=dev)
    irr = torch.empty((n, 3), dtype=torch.float32, device=dev)
    n_out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        launch(entry("u32_chains", "mq_lc_lookup", _LOOKUP_ARGS), dev,
               rng_state.data_ptr(), pos.data_ptr(), *pos.stride(), normal.data_ptr(),
               *normal.stride(), None if level is not None else cam_x.data_ptr(),
               None if level is None else level.data_ptr(),
               None if dead is None else dead.data_ptr(), table.data_ptr(), n,
               *grids.level_scale(cfg, "light_cache"), cfg.lc_size, cfg.grid_tile_bits,
               rng_out.data_ptr(), irr.data_ptr(), n_out.data_ptr())
        lookup.launches += 1
    return rng_out, irr, n_out


lookup.launches = 0


def lc_get(rng_state, lc: LightCache, pos, normal, cam_x, cfg: MCPGConfig,
           packed=None, dead=None):
    """Returns (rng, irradiance [..., 3]).

    ``packed``: optional _pack_lc(lc) table — pass it when calling in a
    loop so the (L, 5) pack is built once, not per call. ``dead``:
    optional bool mask of lanes whose result the caller discards."""
    table = _pack_lc(lc) if packed is None else packed
    rng_state, irr, _ = lookup(rng_state, table, pos, normal, cfg, cam_x=cam_x, dead=dead)
    return rng_state, irr


def lc_update_batch(
    rng_state,
    lc: LightCache,
    pos,
    normal,
    irr,
    mask,
    cam_x,
    cfg: MCPGConfig,
    tiebreak=None,
):
    """Batched light-cache update over M samples.

    pos/normal/irr: [M, 3]; mask: bool[M]. Returns
    (rng, new lc, applied_cells, merged_samples), the counts as 0-d
    int64 tensors.

    Aggregation is sort-based and COMPACT-FIRST (ops/segments.py): after
    one sort the per-cell math runs on the compacted segment-end rows
    (≤ update_cell_capacity), and only capacity-row scatters touch the
    cache. Per-cell mean irradiance comes from cumulative-sum differences
    at compacted end rows; the representative sample (→ coarse-level
    re-init site) is the segment-end row. The irradiance and the count
    ride the sort as f16 pairs, as in the JAX package (the mean is taken
    over f16-rounded samples).
    """
    mask = mask & torch.isfinite(irr).all(-1)
    level = _lc_level(pos, cam_x, cfg)
    rng_state, buf, h = _lc_cell(rng_state, pos, normal, level, cfg)
    L = cfg.lc_size
    bi = torch.where(mask, buf, L)
    mf = mask.to(torch.float32)
    # sanitize non-finite rows BEFORE the cumulative sum (0*inf = NaN)
    irr = torch.where(mask[:, None], irr, 0.0)

    m = bi.shape[0]
    iota = torch.arange(m, dtype=torch.int64, device=bi.device)
    # ``tiebreak`` (the global row index) makes the within-cell order —
    # and so the segment-end representative and the f32 sum order —
    # independent of how the rows were concatenated
    segs, cols = segments.sort_segments(
        bi,
        [pack_f16_pair(irr[:, 0], irr[:, 1]), pack_f16_pair(irr[:, 2], mf), iota],
        tiebreak=tiebreak,
    )
    ix, iy = unpack_f16_pair(cols[0])
    iz, mf_s = unpack_f16_pair(cols[1])
    idx_s = cols[2]

    cap = int(min(L + 1, cfg.update_cell_capacity))
    comp = segments.compact_indices(segs, cap)
    cell_c = segments.take_compact(comp, segs.cell, fill=L).to(torch.int64)
    acc = segments.compact_sums(
        comp, torch.stack([mf_s, ix, iy, iz], dim=1)
    )  # (cap, 4): count + irr sum per touched cell
    rep_idx = torch.clamp_min(segments.take_compact(comp, idx_s), 0)
    rep_pos, rep_norm, rep_level = pos[rep_idx], normal[rep_idx], level[rep_idx]
    new_hash = h[rep_idx]
    count, sum_irr = acc[:, 0], acc[:, 1:4]

    touched = comp.valid & (cell_c < L) & (count > 0.0)
    cell_r = torch.clamp_max(cell_c, L - 1)
    mean_irr = sum_irr / torch.clamp_min(count, 1.0)[..., None]

    old_hash = lc.hash[cell_r].to(torch.int64) & _M32
    old_irr = lc.irr[cell_r]
    old_n = lc.N[cell_r]

    # cells whose stored hash mismatches: re-init from one coarser level
    mismatch = (old_hash != new_hash) | ~torch.isfinite(old_irr).all(-1)
    # per-CELL rng stream for the coarse-level jitter
    cell_rng = rng_ops.seed_pixel(cell_r, 2, 0, rng_state[0])
    _, coarse_irr, coarse_n = lookup(
        cell_rng, _pack_lc(lc), rep_pos, rep_norm, cfg, level=rep_level + 1.0
    )
    base_irr = torch.where(mismatch[..., None], coarse_irr, old_irr)
    base_n = torch.where(mismatch, coarse_n, old_n)

    new_n = torch.clamp_max(base_n + 1, cfg.lc_max_n)
    alpha = torch.clamp_min(1.0 / torch.clamp_min(new_n, 1), cfg.lc_min_alpha)
    new_irr = base_irr + (mean_irr - base_irr) * alpha[..., None]

    idx = torch.where(touched, cell_c, L)
    out = LightCache(
        hash=segments.scatter_rows(lc.hash, idx, new_hash.to(lc.hash.dtype)),
        irr=segments.scatter_rows(lc.irr, idx, new_irr),
        N=segments.scatter_rows(lc.N, idx, new_n.to(lc.N.dtype)),
    )
    applied = touched.sum()
    merged = mask.sum() - applied
    return rng_state, out, applied, merged
