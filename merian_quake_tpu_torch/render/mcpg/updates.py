"""Two-phase Markov-chain update replay (sort-based).

Port of merian_quake_tpu/render/mcpg/updates.py. Per-cell sample groups
are formed by ONE two-key sort (ops/segments.py):

- sort samples by (cell, negated reservoir race key): groups become
  contiguous segments and the race winner (Efraimidis–Spirakis:
  argmin -log(u)/weight) lands on each segment's END row;
- the sequential EWA over k same-id samples collapses to one batched
  EWA step with effective alpha 1-(1-α)^k against the group mean;
- the winner's stochastic grid writes keep the replacement rule (keep
  the incumbent with probability old.sum_w/(new+old)), applied from a
  compacted per-touched-cell buffer (segments past
  ``update_cell_capacity`` drop).

The race weight of a matching sample is the cell's PRE-update sum_w, the
winner's mv is the w-weighted mean of the frame's matching samples, and
the replacement RNG is seeded per (cell, frame).

Save sites: the winners of different touched cells can hash to one save
site. Among the rows that replace at equal sites, the LAST in compacted
(cell) order writes both tables, on every device (the order in which the
JAX package's scatter applies its updates on the CPU): an unordered
scatter could give a state the id of one chain and the target of
another.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops import linalg, octahedral, rng as rng_ops, segments
from ...ops.hashgrid import u32_to_i32
from ...ops.rng import _M32
from ...utils import profiler
from .. import layout
from .config import MCPGConfig, MCPGState, MCStates
from . import grids
from .light_cache import lc_update_batch
from .light_cache import pack_f16_pair as _pack_f16_pair
from .light_cache import unpack_f16_pair as _unpack_f16_pair
from .surface import SurfaceResult, _f2i, _i2f

_BIGF = 3e38


class CompactedQueues(NamedTuple):
    """Compacted guiding-update queues.

    The raw frame queues are spp·segments·pixels rows of which only the
    gated few percent are live: a class sort keeps a static live prefix.
    RNG replay streams are seeded by the carried GLOBAL row index
    (``gidx``), making the replay order-invariant.

    Columns:
    - upd: i32[capu, 16] — UpdateQueue's 15 emission-packed columns +
      gidx (dead rows carry the sentinel cell);
    - zeros: i32[capz] — fast-recovery cells (sentinel = none);
    - lc: i32[capl, 7] — [pos(3, f32 bits), oct normal (u32 bits),
      irr (2 f16-pair lanes), gidx (-1 = dead)].
    """

    upd: torch.Tensor
    zeros: torch.Tensor
    lc: torch.Tensor


def queue_gidx(m_local, groups, width, rows, y0, height, base=0, device="cuda"):
    """Global row index of each queue row: queues are [group, pixels]-
    ordered, pixels in the TILE-MAJOR flat layout (render/layout.py), so
    the index of a row is base + group·H·W + flat_index(pixel) of the
    whole image, for the slab of image rows [y0, y0 + rows)."""
    per = rows * width
    assert m_local == (m_local // per) * per, (m_local, per)
    groups = m_local // per
    px, py = layout.gen_pixels(width, rows, y0=y0, device=device)
    gpix = layout.index_of(px, py, width, height).to(torch.int32)
    goff = torch.arange(groups, dtype=torch.int32, device=device) * (height * width)
    return base + (goff[:, None] + gpix[None, :]).reshape(-1)


def compact_queues(
    result: SurfaceResult,
    mcfg: MCPGConfig,
    gidx_upd,
    gidx_lc,
    n_shards: int = 1,
) -> CompactedQueues:
    """Class-sort + static-prefix compaction of the frame's queues. The
    sorts are stable: the live prefix, the zero requests taken from the
    TAIL, and which rows drop on overflow are row-order facts.
    ``n_shards``: the row slabs the frame is split into; each keeps
    1/n_shards of every capacity, so the gathered queues hold as many
    rows as one device's."""
    S = mcfg.mc_total_size
    qtab = result.updates.data  # (M, 15)
    M = qtab.shape[0]
    live = qtab[:, 14] < S
    cls = torch.where(live, 0, torch.where(result.zeros.mask, 2, 1)).to(torch.int8)
    ks, ps = torch.sort(cls, stable=True)

    capu = int(min(M, max(mcfg.update_queue_capacity // n_shards, 1024)))
    if profiler.counting():
        # the live rows, and those past the capacity, which drop
        n_live = live.sum()
        profiler.count("mcpg.update_rows_live", n_live)
        profiler.count("mcpg.update_rows_dropped", torch.clamp_min(n_live - capu, 0))
    pu = ps[:capu]
    upd = torch.cat([qtab[pu], gidx_upd.to(torch.int32)[pu][:, None]], dim=1)
    # rows past the live prefix already carry the sentinel cell (the
    # class sort puts live rows first; dead rows keep cell >= S)

    capz = int(min(M, max(mcfg.zero_queue_capacity // n_shards, 256)))
    pz = ps[M - capz:]
    zeros = torch.where(ks[M - capz:] == 2, result.zeros.cell[pz].to(torch.int32), S)

    # light-cache queue: its own liveness sort (different mask)
    lcq = result.lc_samples
    lmask = lcq.mask & torch.isfinite(lcq.irr).all(-1)
    lps = torch.sort((~lmask).to(torch.int8), stable=True).indices
    capl = int(min(M, max(mcfg.lc_queue_capacity // n_shards, 1024)))
    pl = lps[:capl]
    lc_tab = torch.cat(
        [
            _f2i(lcq.pos),
            u32_to_i32(octahedral.encode_normal(lcq.normal))[:, None],
            _pack_f16_pair(lcq.irr[:, 0], lcq.irr[:, 1])[:, None],
            _pack_f16_pair(lcq.irr[:, 2], torch.zeros_like(lcq.irr[:, 2]))[:, None],
            torch.where(lmask, gidx_lc.to(torch.int32), -1)[:, None],
        ],
        dim=1,
    )  # (M, 7)
    return CompactedQueues(upd=upd, zeros=zeros, lc=lc_tab[pl])


def apply_updates(
    rng_key,
    mstate: MCPGState,
    result: SurfaceResult,
    uniforms,
    mcfg: MCPGConfig,
) -> MCPGState:
    """Applies fast-recovery zeros, light-cache samples and MC updates
    from the dense frame queues (compaction + replay in one step, the
    rows numbered as they lie)."""
    M = result.updates.data.shape[0]
    gidx = torch.arange(M, dtype=torch.int32, device=result.updates.data.device)
    cq = compact_queues(result, mcfg, gidx, gidx, n_shards=1)
    return apply_updates_compact(rng_key, mstate, cq, uniforms, mcfg)


def apply_updates_compact(
    rng_key,
    mstate: MCPGState,
    cq: CompactedQueues,
    uniforms,
    mcfg: MCPGConfig,
) -> MCPGState:
    """Replay compacted queues into the guiding state.

    ``rng_key``: u32 seed for this frame's replay randomness. All replay
    sorts are keyed (cell, race) with gidx-seeded races, so the result
    is independent of row ORDER up to f32 segment-sum reassociation.
    """
    mc = mstate.mc
    S = mcfg.mc_total_size
    dev = mc.f.device

    # ---- 1a. fast-recovery zeroing (duplicate cells write the same
    # 0.0 — benign; the sentinel S lands in the scratch row) ----
    sum_w0 = segments.scatter_rows(mc.f[:, 3], cq.zeros, 0.0)
    mc = mc._replace(f=torch.cat([mc.f[:, 0:3], sum_w0[:, None], mc.f[:, 4:]], dim=1))

    # ---- 1b. compacted update rows (emission-packed + gidx) ----
    qr = cq.upd[:, :15]
    cap_u = qr.shape[0]
    w_u = _i2f(qr[:, 0])
    tgt_u = _i2f(qr[:, 1:4])
    mv_u = _i2f(qr[:, 4:7])
    pos_u = _i2f(qr[:, 7:10])
    norm_u = _i2f(qr[:, 10:13])
    id_u = qr[:, 13].to(torch.int64) & _M32
    cells_u = qr[:, 14].to(torch.int64)
    live_u = cells_u < S

    # per-sample rng streams seeded by the GLOBAL queue row index
    # (compaction-invariant streams)
    rs = rng_ops.seed_pixel(cq.upd[:, 15], 0, uniforms.frame, rng_key)

    # ---- 2. light cache (from the compacted narrow rows) ----
    lc_pos = _i2f(cq.lc[:, 0:3])
    lc_norm = octahedral.decode_normal(cq.lc[:, 3].to(torch.int64) & _M32)
    ir0, ir1 = _unpack_f16_pair(cq.lc[:, 4])
    ir2, _ = _unpack_f16_pair(cq.lc[:, 5])
    lc_irr = torch.stack([ir0, ir1, ir2], dim=1)
    lc_gidx = cq.lc[:, 6]
    rng_lc = rng_ops.seed_pixel(torch.clamp_min(lc_gidx, 0), 1, uniforms.frame, rng_key)
    _, lc, applied, merged = lc_update_batch(
        rng_lc,
        mstate.lc,
        lc_pos,
        lc_norm,
        lc_irr,
        lc_gidx >= 0,
        uniforms.cam_x,
        mcfg,
        tiebreak=lc_gidx,
    )

    # ---- 3. MC chain replay on the compacted rows ----
    # narrow 2-column incumbent peek (id, sum_w)
    inc_tab = torch.stack([mc.i[:, 0], _f2i(mc.f[:, 3])], dim=1)  # (S, 2) i32
    inc = grids.gather_rows(inc_tab, torch.clamp_max(cells_u, S - 1))  # (cap_u, 2)
    inc_id = inc[:, 0].to(torch.int64) & _M32
    inc_sum_w = _i2f(inc[:, 1])
    match = (inc_id == id_u) & live_u

    # reservoir race key (winner = min); sorted DESC via negation so the
    # winner is the segment-end row
    rs, u_race = rng_ops.uniform(rs)
    cand_w = torch.where(match, inc_sum_w, w_u)
    race = -torch.log(torch.clamp_min(u_race, 1e-12)) / torch.clamp_min(cand_w, 1e-20)
    key2 = torch.where(live_u, -race, -_BIGF)

    mf = match.to(torch.float32)

    # sort operands are the per-row aggregation inputs ONLY plus the
    # compacted row index: winner-only columns (normal, id) are gathered
    # afterwards at the ≤capacity segment-end rows
    iota_c = torch.arange(cap_u, dtype=torch.int64, device=dev)
    segs, cols = segments.sort_segments(
        cells_u, [w_u, mf, tgt_u, pos_u, mv_u, iota_c], tiebreak=key2
    )
    w_s, m_s, tgt_s, pos_s, mv_s, idx_s = cols

    # ---- compact to one row per touched cell; per-cell math runs on
    # (cap,) rows only ----
    cap = int(min(S + 1, mcfg.update_cell_capacity))
    comp = segments.compact_indices(segs, cap)
    cell_c = segments.take_compact(comp, segs.cell, fill=S).to(torch.int64)
    live_c = comp.valid & (cell_c < S)
    cell_r = torch.clamp_max(cell_c, S - 1)

    # segment aggregates over MATCHING samples (masked rows all carry
    # the sentinel cell and sort into the trailing dead segment)
    mw = m_s * w_s
    agg = segments.compact_sums(
        comp,
        torch.cat([m_s[:, None], mw[:, None], mw[:, None] * tgt_s, mw[:, None] * mv_s], dim=1),
    )  # (cap, 8): k, sum_w, sum_wt(3), sum_wmv(3)
    k_m, sum_w_g, sum_wt_g, sum_wmv_g = agg[:, 0], agg[:, 1], agg[:, 2:5], agg[:, 5:8]

    cur_f = grids.gather_rows(mc.f, cell_r)  # (cap, 9)
    cur_i = grids.gather_rows(mc.i, cell_r)  # (cap, 3)

    kf = torch.clamp_min(k_m, 1.0)
    mean_w = sum_w_g / kf
    mean_wt = sum_wt_g / kf[..., None]
    n_new = torch.clamp_max(cur_i[:, 1] + k_m.to(torch.int32), mcfg.ml_max_n)
    alpha = torch.clamp_min(1.0 / torch.clamp_min(n_new, 1), mcfg.ml_min_alpha)
    alpha_eff = 1.0 - torch.pow(1.0 - alpha, k_m)
    upd_sum_w = cur_f[:, 3] + (mean_w - cur_f[:, 3]) * alpha_eff
    upd_w_tgt = cur_f[:, 0:3] + (mean_wt - cur_f[:, 0:3]) * alpha_eff[..., None]
    mean_mv = sum_wmv_g / torch.clamp_min(sum_w_g, 1e-20)[..., None]

    # cos term against the POST-update state direction (sum_w and w_tgt
    # are written BEFORE w_cos reads the state direction). This
    # bootstraps guiding: a fresh chain's first light-find gives cos = 1
    # → mean cos ≈ 1 → a sharp vMF lobe at the light. The per-row
    # broadcast goes through a small (S, 4) scratch table.
    post_tab = segments.scatter_table(
        comp, cell_c, torch.cat([upd_w_tgt, upd_sum_w[:, None]], dim=1), S + 1
    )
    post = grids.gather_rows(post_tab, torch.clamp_max(segs.cell, S))  # (M, 4)
    pos_post = torch.where(
        (post[:, 3] > 0.0)[..., None],
        post[:, 0:3] / torch.where(post[:, 3] == 0.0, 1.0, post[:, 3])[..., None],
        post[:, 0:3],
    )
    dir_post = linalg.normalize(pos_post - pos_s)
    cos_post = torch.clamp_min(linalg.dot(linalg.normalize(tgt_s - pos_s), dir_post), 0.0)
    cos_post = torch.where(mw > 0.0, cos_post, 0.0)
    sum_wc_g = segments.compact_sums(comp, mw * cos_post)  # (cap,)
    mean_wc = sum_wc_g / kf
    upd_w_cos = torch.minimum(cur_f[:, 4] + (mean_wc - cur_f[:, 4]) * alpha_eff, upd_sum_w)

    # ---- winner row (the segment end) per touched cell ----
    w_c = segments.take_compact(comp, w_s)
    m_c = segments.take_compact(comp, m_s)
    tgt_c = segments.take_compact(comp, tgt_s)
    mv_c = segments.take_compact(comp, mv_s)
    pos_c = segments.take_compact(comp, pos_s)
    # winner-only columns from the COMPACTED queue rows (cap-row gather)
    win_idx = torch.clamp_min(segments.take_compact(comp, idx_s), 0)
    norm_c = norm_u[win_idx]
    win_id_s = id_u[win_idx]

    winner_match = m_c > 0.5
    # matched winner → the post-EWA cell state; fresh winner → a new
    # chain from the sample (cos = 1 by construction)
    win_f = torch.where(
        winner_match[:, None],
        torch.cat([upd_w_tgt, upd_sum_w[:, None], upd_w_cos[:, None], mean_mv], dim=1),
        torch.cat([w_c[:, None] * tgt_c, w_c[:, None], w_c[:, None], mv_c], dim=1),
    )  # (cap, 8): w_tgt3, sum_w, w_cos, mv3
    win_id = torch.where(winner_match, cur_i[:, 0].to(torch.int64) & _M32, win_id_s)
    win_n = torch.where(winner_match, n_new, 1)
    win_valid = live_c

    # save-site cells: stochastic level/jitter drawn per WINNER, so the
    # hash math runs on cap rows, not M
    rc = rng_ops.seed_pixel(cell_r, 3, uniforms.frame, rng_key)
    rc, sbuf_c, shash_c = grids.static_cell(rc, pos_c, mcfg)
    rc, abuf_c, ahash_c = grids.adaptive_cell(rc, pos_c, norm_c, uniforms.cam_x, mcfg)

    iota_cap = torch.arange(cap, dtype=torch.int64, device=dev)
    f_rows = torch.cat(
        [win_f, linalg.as_f32(uniforms.cl_time, win_f).expand(cap, 1)], dim=1
    )

    # ---- stochastic saves into BOTH grids ----
    def save(mc: MCStates, buf, site_hash, stream: int) -> MCStates:
        old = grids.gather_rows(inc_tab, torch.clamp_max(buf, S - 1))
        old_id = old[:, 0].to(torch.int64) & _M32
        old_sum_w = _i2f(old[:, 1])
        cell_rng = rng_ops.seed_pixel(buf, 4 + stream, uniforms.frame, rng_key)
        _, u_rep = rng_ops.uniform(cell_rng)
        new_sum_w = win_f[:, 3]
        replace = win_valid & (
            (old_id == win_id) | (u_rep < new_sum_w / (new_sum_w + old_sum_w))
        )
        idx = torch.where(replace, buf, S)
        # equal save sites: the last replacing row in cell order writes
        # both tables (see the module docstring)
        last = torch.full((S + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
            0, idx, iota_cap, "amax"
        )
        idx = torch.where(last[idx] == iota_cap, idx, S)
        i_rows = torch.stack(
            [u32_to_i32(win_id), win_n.to(torch.int32), u32_to_i32(site_hash)], dim=1
        )
        return MCStates(
            f=segments.scatter_rows(mc.f, idx, f_rows),
            i=segments.scatter_rows(mc.i, idx, i_rows),
        )

    mc = save(mc, sbuf_c, shash_c, 0)  # static grid
    mc = save(mc, abuf_c, ahash_c, 1)  # adaptive grid

    return MCPGState(
        mc=mc,
        lc=lc,
        lc_updates_applied=(mstate.lc_updates_applied + applied) & _M32,
        lc_updates_merged=(mstate.lc_updates_merged + merged) & _M32,
    )
