"""MCPG guided surface pass.

Port of merian_quake_tpu/render/mcpg/surface.py: per pixel and sample,
each bounce draws MC_SAMPLES Markov-chain states from the two hash grids
(statically split between the adaptive and the static grid),
reservoir-selects a winner by sum_w, samples the outgoing direction
defensively (BSDF w.p. surf_bsdf_p, else the winner's vMF lobe), and
MIS-combines the vMF mixture with the BSDF pdf. Paths emit light-cache
samples and Markov-chain update samples into dense masked queues, plus
fast-recovery zero requests for vanished lights.

The draw order and the RNG consumption of ``segment_body`` follow the
JAX package line for line: one stream value out of place and every
later decision differs. The bounce rays are traced as they lie (no
coherence sort) unless a trace schedule sorts them by its target key.
The default configuration reads no device value from the host; a
compacted segment (``surf_live_budget``) reads one, its live count.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...accel.build import AccelScene
from ...models.types import RenderConfig, TextureAtlas, Uniforms
from ...ops import bsdf, color as color_ops, linalg, rng as rng_ops, vmf
from ...ops.hashgrid import u32_to_i32
from ...utils import profiler
from .. import layout
from ..gbuffer import GBufferOutput
from ..hit import Hit, decompress_hit
from ..pt import _where_hit, sorts_bounce_rays
from ..trace import trace_ray
from .config import MCPGConfig, MCPGState
from . import draw, grids
from .draw import _select_state
from .light_cache import _pack_lc, lc_get


def _f2i(x):
    """f32 → i32 lanes, by the bits."""
    return x.contiguous().view(torch.int32)


def _i2f(x):
    return x.contiguous().view(torch.float32)


class UpdateQueue(NamedTuple):
    """Dense masked MC update samples, PACKED at emission into one i32
    matrix. Column layout (15): [w, target(3), mv(3), pos(3), normal(3),
    id, cell] — floats by their bits, the u32 id by its bits, dead rows
    carry the sentinel cell (>= mc_total_size), encoding the mask.
    """

    data: torch.Tensor  # i32[..., 15]

    @classmethod
    def build(cls, cell, id, w, target, mv, pos, normal, mask, sentinel):
        data = torch.cat(
            [
                _f2i(w)[..., None],
                _f2i(target),
                _f2i(mv),
                _f2i(pos),
                _f2i(normal),
                u32_to_i32(id)[..., None],
                torch.where(mask, cell, sentinel).to(torch.int32)[..., None],
            ],
            dim=-1,
        )
        return cls(data=data)

    @property
    def w(self):
        return _i2f(self.data[..., 0])

    @property
    def target(self):
        return _i2f(self.data[..., 1:4])

    @property
    def mv(self):
        return _i2f(self.data[..., 4:7])

    @property
    def pos(self):
        return _i2f(self.data[..., 7:10])

    @property
    def normal(self):
        return _i2f(self.data[..., 10:13])

    @property
    def id(self):
        return self.data[..., 13].to(torch.int64) & 0xFFFFFFFF

    @property
    def cell(self):
        return self.data[..., 14]


class LCQueue(NamedTuple):
    pos: torch.Tensor  # f32[M, 3]
    normal: torch.Tensor
    irr: torch.Tensor
    mask: torch.Tensor


class ZeroQueue(NamedTuple):
    """Fast-recovery sum_w zero requests."""

    cell: torch.Tensor  # i32[M]
    mask: torch.Tensor


class DistQueue(NamedTuple):
    """Distance-MC state writes from the volume pass, deferred to the
    replay (columns [sw, m0, m1, N, flat]: f32 by their bits in i32
    lanes; dropped rows carry the sentinel flat index). Later volume spp
    samples read the frame-start states, not same-frame writes."""

    data: torch.Tensor  # i32[M, 5]

    @classmethod
    def build(cls, sw, m0, m1, n_chain, flat, mask, sentinel):
        return cls(
            data=torch.stack(
                [
                    _f2i(sw), _f2i(m0), _f2i(m1), n_chain.to(torch.int32),
                    torch.where(mask, flat, sentinel).to(torch.int32),
                ],
                dim=-1,
            )
        )


class SurfaceResult(NamedTuple):
    irradiance: torch.Tensor  # f32[H, W, 4]
    updates: UpdateQueue
    lc_samples: LCQueue
    zeros: ZeroQueue
    dist: DistQueue | None = None  # volume pass only
    # i32[segments] count of lanes still alive ENTERING each bounce
    # segment (out of spp·W·H): drives the live-lane compaction budget
    # choice. None on results built by hand.
    live_in: torch.Tensor | None = None
    # i32[M] GLOBAL row id per queue row ((seg·spp + sample)·H·W + pixel
    # index): under live-lane compaction queue rows are in
    # liveness-sorted lane order, so the id must ride with the row.
    gidx: torch.Tensor | None = None


# smallest lane population worth the live-lane compaction sorts
# (patched down by tests to exercise the compacted path at toy sizes)
COMPACT_MIN_NS = 1 << 16


def _seg_budgets(mcfg: MCPGConfig, segs_n: int, ns: int) -> list[int]:
    """Static per-segment lane budgets (live-lane compaction).

    ``mcfg.surf_live_budget`` gives the fraction of the spp·pixels lane
    population each bounce segment is expected to need (indexed by
    segment, last entry repeats). 1.0 / empty = no compaction. Tiny
    populations (tests, thumbnails) skip compaction."""
    fr = mcfg.surf_live_budget
    out = []
    for s in range(segs_n):
        frac = fr[min(s, len(fr) - 1)] if fr else 1.0
        if frac >= 1.0 or ns < COMPACT_MIN_NS:
            out.append(ns)
        else:
            b = max(1024, -(-int(ns * frac) // 1024) * 1024)
            out.append(min(ns, b))
    return out


def pack_tables(mstate: MCPGState, uniforms: Uniforms):
    """The frame's packed draw table and light-cache table, which the
    surface and the volume pass both read."""
    return grids.pack_states_draw(mstate.mc, uniforms.cl_time), _pack_lc(mstate.lc)


def render_mcpg_surface(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    mcfg: MCPGConfig,
    mstate: MCPGState,
    gbuf: GBufferOutput,
    schedule=None,
    packed=None,
    y0=0,
    rows: int | None = None,
) -> SurfaceResult:
    """``packed``: the frame's (``grids.pack_states_draw``, ``_pack_lc``)
    tables when the caller shares them with the volume pass; built here
    otherwise. ``y0``/``rows``: the image-row slab; its queue rows carry
    their GLOBAL row ids, so the gathered queues replay as one image's."""
    W, H = config.width, config.height
    rows = H if rows is None else rows
    n = W * rows
    K = mcfg.mc_samples
    spp = max(config.spp, 1)
    cam_x = uniforms.cam_x
    mc = mstate.mc
    lc = mstate.lc
    dev = mc.f.device

    # ALL spp samples ride in ONE ray population (ns = spp·n). RNG
    # streams are seeded per (sample, pixel).
    pxi, pyi = layout.gen_pixels(W, rows, y0=y0, device=dev)
    ns = n * spp
    tile = (lambda x: torch.cat([x] * spp, dim=0)) if spp > 1 else (lambda x: x)
    samp = torch.arange(spp, dtype=torch.int64, device=dev).repeat_interleave(n)
    state0 = rng_ops.seed_pixel(
        tile(pxi),
        tile(pyi),
        uniforms.frame,
        (int(config.seed) & 0xFFFFFFFF) ^ ((samp * 0x9E3779B9) & 0xFFFFFFFF),
    )
    first_spp = samp == 0
    # one (S, 8) packed draw table (temporal reprojection pre-applied
    # table-side): each of the K×segments state draws pays a single
    # 8-column gather; one row-gather per lc_get, not three
    mc_packed, lc_packed = packed if packed is not None else pack_tables(mstate, uniforms)

    first_hit = Hit(*[tile(x) for x in decompress_hit(gbuf.hits)])
    pixel_live = (first_hit.albedo >= 1e-7).any(-1)

    # per-lane GLOBAL queue-row id base: (sample group)·H·W + pixel index
    gpix = layout.index_of(pxi, pyi, W, H).to(torch.int32)
    samp_row = samp.to(torch.int32) * (H * W) + tile(gpix)

    def segment_body(seg_idx, rng_state, cur, throughput, f, p, done, first_lane):
        """One bounce segment over an arbitrary lane population.

        Shape-generic over the leading dim (full frame or a compacted
        live prefix); ``seg_idx`` is a Python int. Returns the updated
        per-lane state plus this segment's emission queues (same leading
        dim as the input).
        """
        nl = cur.pos.shape[0]
        # sample 0 looks up at the previous-frame position (better
        # temporal stability), later samples at the current one
        lookup_pos = torch.where(first_lane[:, None], cur.prev_pos, cur.pos)

        # ---- draw K chain states, reservoir-select by sum_w ----
        # STRATIFIED grid choice: draw slots are statically assigned —
        # floor(K·p) adaptive, K−ceil(K·p) static, one Bernoulli(frac)
        # boundary slot — so all but one draw run ONE grid's math. Draws
        # are exchangeable in the reservoir and the MIS mixture, and the
        # expected adaptive count stays exactly K·p. Dead lanes gather
        # row 0 (everything downstream is gated on ``active``); static
        # draws are tested against the surface's hemisphere.
        with profiler.span(f"mcpg.surface.seg{seg_idx}.draw", cur.pos):
            dr = draw.draw_states(
                rng_state, lookup_pos, cur.pos, cur.normal, cam_x, uniforms.cl_time, mc_packed,
                mcfg, dead=done, hemisphere=True,
            )
        rng_state, win, win_buf, score_sum = dr.rng, dr.win, dr.win_buf, dr.score_sum
        mus, kappas, scores, draw_ns = dr.mu, dr.kappa, dr.sum_w, dr.N

        have_guiding = score_sum > 0.0

        # ---- defensive direction sampling ----
        # per-DRAW defensive probability: immature chains (small N)
        # sample mostly BSDF (config surf_bsdf_trust_n). The sample
        # decision uses the realized winner's sbp; the MIS pdf below
        # mixes per-draw sbp_i over the reservoir weights, which is
        # EXACTLY the marginal sampling density.
        def _sbp_of(n_arr):
            if mcfg.surf_bsdf_trust_n <= 0:
                return torch.full(tuple(n_arr.shape), mcfg.surf_bsdf_p, device=dev)
            nf = n_arr.to(torch.float32)
            mat = nf / (nf + float(mcfg.surf_bsdf_trust_n))
            return 1.0 - (1.0 - mcfg.surf_bsdf_p) * mat

        sbp = _sbp_of(win.N)
        rng_state, u_b = rng_ops.uniform(rng_state)
        use_bsdf = (~have_guiding) | (u_b < sbp)
        alpha = bsdf.roughness_to_alpha(cur.roughness)
        rng_state, u3 = rng_ops.uniform3(rng_state)
        wo_b = bsdf.sample(cur.wi, cur.normal, alpha, u3)
        win_mu, win_kappa = grids.state_vmf(win, cur.pos, mcfg)
        rng_state, u2 = rng_ops.uniform2(rng_state)
        wo_g = vmf.sample(win_mu, win_kappa, u2)
        wo = torch.where(use_bsdf[..., None], wo_b, wo_g)
        rng_state, fresh = grids.new_state(rng_state)
        mc_state = _select_state(use_bsdf, fresh, win)
        mc_idx = torch.where(use_bsdf, -1, win_buf)

        wodotn = linalg.dot(wo, cur.normal)
        below = (wodotn <= 1e-3) | (linalg.dot(wo, cur.geo_normal) <= 1e-3)
        active = ~done & ~below

        # ---- MIS pdf: exact marginal of the per-draw defensive
        # mixture ----
        safe_sum = torch.where(have_guiding, score_sum, 1.0)
        bsdf_mix = torch.zeros((nl,), device=dev)
        guided_p = torch.zeros((nl,), device=dev)
        for mu_i, kap_i, sc_i, n_i in zip(mus, kappas, scores, draw_ns):
            sbp_i = _sbp_of(n_i)
            w_i = sc_i / safe_sum
            bsdf_mix = bsdf_mix + w_i * sbp_i
            guided_p = guided_p + w_i * (1.0 - sbp_i) * vmf.pdf(wo, mu_i, kap_i)
        bsdf_p = bsdf.pdf(cur.wi, wo, cur.normal, alpha)
        wo_p = (
            torch.where(have_guiding, bsdf_mix, 1.0) * bsdf_p
            + torch.where(have_guiding, guided_p, 0.0)
        )

        # ---- trace next segment (dead lanes masked: they trace with
        # t_max = -1 → uniform miss; every consumer below is already
        # gated on ``active``) ----
        origin = cur.pos - cur.wi * 1e-3
        res = trace_ray(
            accel, atlas, uniforms, origin, wo,
            bilinear=config.bilinear, features=config.features,
            sort_rays=sorts_bounce_rays(schedule), active=active, schedule=schedule,
        )
        incident = res.contribution
        has_inc = (incident > 0.0).any(-1)

        rng_state, lc_irr = lc_get(
            rng_state, lc, res.hit.pos, res.hit.normal, cam_x, mcfg,
            packed=lc_packed, dead=~active,
        )
        if (not mcfg.use_light_cache_tail) and config.max_path_length == 2:
            use_inc = torch.ones_like(has_inc)
        else:
            use_inc = has_inc
        lc_incident = torch.where(use_inc[..., None], incident, res.throughput * lc_irr)

        micro = bsdf.eval_times_cos(cur.wi, wo, cur.normal, alpha)
        new_thr = throughput * micro[..., None]
        if mcfg.use_light_cache_tail:
            last = seg_idx == config.max_path_length - 2
            new_f = new_thr * (lc_incident if last else incident)
        else:
            new_f = new_thr * incident
        new_p = p * wo_p

        # ---- guiding updates ----
        mc_f = color_ops.yuv_luminance(lc_incident * micro[..., None] / wo_p[..., None])
        if mcfg.mc_update_clamp > 0.0:
            # luminance-clamped guiding updates (config knob); NaN stays
            # NaN, as in the JAX package's minimum
            mc_f = torch.minimum(mc_f, linalg.as_f32(mcfg.mc_update_clamp, mc_f))
        finite = torch.isfinite(mc_f)
        lc_val = (
            lc_incident
            * (cur.albedo / math.pi)
            * (wodotn / torch.clamp_min(wo_p, 10.0))[..., None]
        )
        lc_mask = active & finite

        rng_state, u_acc = rng_ops.uniform(rng_state)
        accept = u_acc * score_sum < mc_f * K  # NaN-compare false
        rng_state, fb_buf, _ = grids.adaptive_cell(
            rng_state, cur.pos, cur.normal, cam_x, mcfg
        )
        up_cell = torch.where(mc_idx >= 0, mc_idx, fb_buf)
        target_mv = (res.hit.pos - res.hit.prev_pos) / uniforms.time_diff
        up_mask = active & finite & accept

        missing = grids.light_missing(mc_state, mc_f, wo, cur.pos, mcfg)
        zero_mask = active & finite & ~accept & (mc_idx >= 0) & missing
        if not mcfg.mc_fast_recovery:
            zero_mask = torch.zeros_like(zero_mask)

        ys = (
            LCQueue(pos=cur.pos, normal=cur.normal, irr=lc_val, mask=lc_mask),
            UpdateQueue.build(
                cell=up_cell,
                id=mc_state.id,
                w=mc_f,
                target=res.hit.pos,
                mv=target_mv,
                pos=cur.pos,
                normal=cur.normal,
                mask=up_mask,
                sentinel=mcfg.mc_total_size,
            ),
            ZeroQueue(cell=torch.clamp_min(mc_idx, 0).to(torch.int32), mask=zero_mask),
        )

        # ---- commit path state on active lanes ----
        throughput = torch.where(active[..., None], new_thr, throughput)
        f = torch.where(active[..., None], new_f, f)
        p = torch.where(active, new_p, p)
        throughput = torch.where(
            active[..., None], throughput * res.throughput * res.hit.albedo, throughput
        )
        cur = _where_hit(active, res.hit, cur)
        dead = (throughput < 1e-7).all(-1) | (f > 1e-7).any(-1)
        done = done | below | dead
        return rng_state, cur, throughput, f, p, done, ys

    # ---------- segment loop: a Python loop with optional LIVE-LANE
    # COMPACTION ----------
    # After the first bounce most lanes are dead (sky/emission hits), yet
    # every per-lane op in a segment still runs at full width. When a
    # segment's static budget B < ns, the lanes are sorted live-first
    # (one stable sort, the whole path state gathered by its
    # permutation), the segment body runs on the [0:B) prefix only, and
    # the dead suffix passes through untouched. It falls back to the
    # full-width body when more than B lanes are alive (enclosed scenes),
    # so the estimator is EXACTLY unbiased either way.
    rng_state = state0
    cur = first_hit
    throughput = torch.ones((ns, 3), device=dev)
    f = torch.zeros((ns, 3), device=dev)
    p = torch.ones((ns,), device=dev)
    done = ~pixel_live
    first_lane = first_spp
    iota_l = torch.arange(ns, dtype=torch.int64, device=dev)
    row_l = samp_row
    segs_n = max(config.max_path_length - 1, 0)
    buds = _seg_budgets(mcfg, segs_n, ns)
    sorted_mode = False
    ys_list = []
    gidx_list = []
    live_list = []

    def _pad_rows(x, rows_to, fill):
        if x.shape[0] == rows_to:
            return x
        pad = torch.full(
            (rows_to - x.shape[0],) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=dev
        )
        return torch.cat([x, pad])

    def _pad_ys(ys, rows_to, sentinel):
        lcq, upq, zq = ys
        updata = _pad_rows(upq.data, rows_to, 0)
        if updata.shape[0] != upq.data.shape[0]:
            # dead pad rows must carry the sentinel cell (the mask)
            updata[upq.data.shape[0]:, 14] = sentinel
        return (
            LCQueue(
                pos=_pad_rows(lcq.pos, rows_to, 0.0),
                normal=_pad_rows(lcq.normal, rows_to, 0.0),
                irr=_pad_rows(lcq.irr, rows_to, 0.0),
                mask=_pad_rows(lcq.mask, rows_to, False),
            ),
            UpdateQueue(data=updata),
            ZeroQueue(
                cell=_pad_rows(zq.cell, rows_to, 0),
                mask=_pad_rows(zq.mask, rows_to, False),
            ),
        )

    for seg_idx in range(segs_n):
        with profiler.span(f"mcpg.surface.seg{seg_idx}", f):
            live_cnt = (~done).sum()
            live_list.append(live_cnt.to(torch.int32))
            B = buds[seg_idx]
            if B >= ns:
                profiler.count("mcpg.lanes_run", ns)
                rng_state, cur, throughput, f, p, done, ys = segment_body(
                    seg_idx, rng_state, cur, throughput, f, p, done, first_lane
                )
                ys_list.append(ys)
                gidx_list.append(seg_idx * spp * H * W + row_l)
                continue
            # live lanes first; stable, so each class keeps its lane order
            perm = torch.sort(done.to(torch.int8), stable=True).indices
            srt = lambda x: x[perm]
            rng_state, iota_l, row_l, first_lane = (
                srt(rng_state), srt(iota_l), srt(row_l), srt(first_lane)
            )
            cur = Hit(*[srt(x) for x in cur])
            throughput, f, p, done = srt(throughput), srt(f), srt(p), srt(done)
            # the one host read of this pass: which width runs
            width = B if bool(live_cnt <= B) else ns
            profiler.count("mcpg.lanes_run", width)
            pre = lambda x: x[:width]
            rng_s, cur_s, thr_s, f_s, p_s, done_s, ys = segment_body(
                seg_idx, pre(rng_state), Hit(*[pre(x) for x in cur]), pre(throughput),
                pre(f), pre(p), pre(done), pre(first_lane),
            )
            mrg = lambda a, b: torch.cat([a, b[width:]])
            rng_state = mrg(rng_s, rng_state)
            cur = Hit(*[mrg(a, b) for a, b in zip(cur_s, cur)])
            throughput, f, p, done = (
                mrg(thr_s, throughput), mrg(f_s, f), mrg(p_s, p), mrg(done_s, done)
            )
            sorted_mode = True
            ys_list.append(_pad_ys(ys, ns, mcfg.mc_total_size))
            gidx_list.append(_pad_rows(seg_idx * spp * H * W + row_l[:width], ns, 0))

    if sorted_mode:
        # one final unsort of the per-lane contribution (queues carry
        # their own global row ids and never need unsorting)
        f = torch.empty_like(f).index_copy_(0, iota_l, f)
        p = torch.empty_like(p).index_copy_(0, iota_l, p)
    contrib = f / torch.clamp_min(p, 1e-30)[..., None]
    ok = torch.isfinite(contrib).all(-1)
    contrib = torch.where((ok & pixel_live)[..., None], contrib, 0.0)
    lum = color_ops.yuv_luminance(contrib)
    l2 = lum * lum

    if config.spp > 0:
        irr = contrib.reshape(spp, n, 3).mean(0)
        m2 = l2.reshape(spp, n).mean(0)
    else:
        irr = torch.zeros((n, 3), device=dev)
        m2 = torch.zeros((n,), device=dev)

    # flatten per-segment queues → (segs·ns,)
    if ys_list:
        cat = lambda i, cls: cls(*[torch.cat(xs) for xs in zip(*[ys[i] for ys in ys_list])])
        lcq, upq, zq = cat(0, LCQueue), cat(1, UpdateQueue), cat(2, ZeroQueue)
        gidx = torch.cat(gidx_list)
        live_in = torch.stack(live_list)
        if profiler.counting():
            # the lanes that entered a segment alive, against those it ran
            profiler.count("mcpg.lanes_live", live_in.sum())
    else:  # max_path_length < 2: no bounce segments
        z = torch.zeros((0,), dtype=torch.int32, device=dev)
        z3 = torch.zeros((0, 3), device=dev)
        zb = torch.zeros((0,), dtype=torch.bool, device=dev)
        lcq = LCQueue(pos=z3, normal=z3, irr=z3, mask=zb)
        upq = UpdateQueue(data=torch.zeros((0, 15), dtype=torch.int32, device=dev))
        zq = ZeroQueue(cell=z, mask=zb)
        gidx = z
        live_in = z

    img = layout.flat_to_image(torch.cat([irr, m2[..., None]], dim=-1), W, rows)
    return SurfaceResult(
        irradiance=img, updates=upq, lc_samples=lcq, zeros=zq,
        live_in=live_in, gidx=gidx,
    )
