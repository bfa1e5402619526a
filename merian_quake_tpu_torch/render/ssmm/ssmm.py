"""SSMM pass (port of merian_quake_tpu/render/ssmm/ssmm.py).

Defaults mirror the reference's render_ssmm.hpp. The subgroup shuffle
that passes tentative chains between lanes is a roll by one over the
flat pixel buffer, in buffer order (tiled at sizes that tile, see
render.layout); the previous-frame state buffer is read with
motion-vector offset plus a ±15 px tent-distributed jitter, gated by an
SVGF-style normal/depth compatibility score (``read_neighbour_state``).
A row slab of a multi-device frame reads them from the gathered image.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...accel.build import AccelScene
from ...models.types import RenderConfig, TextureAtlas, Uniforms
from ...ops import bsdf, color as color_ops, linalg, rng as rng_ops, vmf
from .. import layout
from ..gbuffer import GBufferOutput
from ..hit import decompress_hit
from ..pt import sorts_bounce_rays
from ..trace import trace_ray


class SSMMConfig(NamedTuple):
    surf_bsdf_p: float = 0.15
    ml_prior_n: float = 0.2
    ml_max_n: int = 1024
    ml_min_alpha: float = 0.01
    smis_group_size: int = 5


class SSMMState(NamedTuple):
    """SSMCState SoA over pixels (ssmc_state.h)."""

    sum_tgt: torch.Tensor  # f32[N, 3]
    sum_w: torch.Tensor  # f32[N]
    N: torch.Tensor  # i32[N]
    sum_len: torch.Tensor  # f32[N]
    f: torch.Tensor  # f32[N]


def _state_new(n, device="cuda") -> SSMMState:
    z = lambda *s: torch.zeros((n,) + s, device=device)
    return SSMMState(
        sum_tgt=z(3), sum_w=z(), N=torch.zeros((n,), dtype=torch.int32, device=device),
        sum_len=z(), f=z(),
    )


def init_ssmm_state(width: int, height: int, device="cuda") -> SSMMState:
    return _state_new(width * height, device)


def _sel(mask, a: SSMMState, b: SSMMState) -> SSMMState:
    pick = lambda x, y: torch.where(mask[..., None] if x.dim() > 1 else mask, x, y)
    return SSMMState(*[pick(x, y) for x, y in zip(a, b)])


def _state_dir(s: SSMMState, x):
    tgt = s.sum_tgt / torch.where(s.sum_w > 0.0, s.sum_w, 1.0)[..., None]
    return linalg.normalize(tgt - x)


def _state_add(s: SSMMState, x, w, direction, y, cfg: SSMMConfig) -> SSMMState:
    """mc_state_add (ssmm.comp:47-57), GLSL mutation order preserved."""
    n_new = torch.clamp_max(s.N + 1, cfg.ml_max_n)
    alpha = torch.clamp_min(1.0 / torch.clamp_min(n_new, 1), cfg.ml_min_alpha)
    sum_w = s.sum_w + (w - s.sum_w) * alpha
    sum_tgt = s.sum_tgt + (w[..., None] * y - s.sum_tgt) * alpha[..., None]
    mid = s._replace(N=n_new, sum_w=sum_w, sum_tgt=sum_tgt)
    to = s.sum_len[..., None] * _state_dir(mid, x)
    to = to + (w[..., None] * direction - to) * alpha[..., None]
    return mid._replace(sum_len=linalg.norm(to))


def _state_vmf(s: SSMMState, x, cfg: SSMMConfig):
    r = s.sum_len / torch.where(s.sum_w > 0.0, s.sum_w, 1.0)
    n2 = (s.N * s.N).to(torch.float32)
    r = torch.clamp(n2 * r / (n2 + cfg.ml_prior_n), 0.0, 0.9999999)
    return _state_dir(s, x), vmf.kappa_from_mean_cos(r)


def _state_score(s: SSMMState, x, nx, normal_img, z_img, cam_x, idx):
    """f × SVGF-style compatibility (mc_state_C, ssmm.comp:76-97)."""
    nq = normal_img[idx]
    zq = z_img[idx]
    w_n = torch.pow(torch.clamp_min(linalg.dot(nx, nq), 0.0), 64.0)
    w_d = torch.exp(-(zq - linalg.distance(x, cam_x)).abs() / 10.0)
    return s.f * w_n * w_d


def _to_int(s):
    """``astype(int32)`` of the JAX package: truncation toward zero,
    saturating at the int32 range, NaN read as 0. Kept in int64, so that
    adding a jitter offset to a saturated value cannot wrap."""
    t = torch.nan_to_num(torch.trunc(s), nan=0.0)
    return torch.clamp(t, -2.0**31, 2.0**31 - 1).to(torch.int64)


def render_ssmm(
    accel: AccelScene,
    atlas: TextureAtlas,
    uniforms: Uniforms,
    config: RenderConfig,
    scfg: SSMMConfig,
    sstate: SSMMState,
    gbuf: GBufferOutput,
    schedule=None,
    y0=0,
    rows: int | None = None,
    shard_ctx=None,
):
    """SSMM pass over image rows [y0, y0 + rows) (default: the whole
    image). Returns (irradiance f32[rows, W, 4] (rgb, second moment), new
    SSMMState of the slab). ``schedule``: the card's trace schedule
    (accel.woop.TraceSchedule; None: the default routes).

    On a row slab (``shard_ctx``, post.sharded.ShardCtx) the previous
    frame's state and the geometry around the motion vector's target
    (±15 px jitter) are read from the gathered image, and the lane
    shuffle stays the whole buffer's roll: each slab passes its last lane
    to the next (``ShardCtx.roll1``, wrapping at the last slab)."""
    W, H = config.width, config.height
    rows = H if rows is None else rows
    n = W * rows
    dev = accel.woop_w.device
    pxf, pyf = layout.gen_pixels(W, rows, y0=y0, device=dev)
    rng = rng_ops.seed_pixel(pxf, pyf, uniforms.frame, config.seed)
    gf = (lambda x: x) if shard_ctx is None else (lambda x: shard_ctx.gather_flat(x, W))

    surf = decompress_hit(gbuf.hits)
    live = (surf.albedo >= 1e-7).any(-1)
    normal_img = gf(layout.image_to_flat(gbuf.normal, W, rows))
    z_img = gf(layout.image_to_flat(gbuf.linear_z, W, rows))
    mv = layout.image_to_flat(gbuf.mv, W, rows)
    cam_x = uniforms.cam_x
    alpha_r = bsdf.roughness_to_alpha(surf.roughness)
    sstate_full = SSMMState(*[gf(x) for x in sstate])
    # the subgroup shuffle: every lane's tentative chain moves one lane on
    # in flat buffer order
    roll1 = (lambda x: torch.roll(x, 1, 0)) if shard_ctx is None else shard_ctx.roll1
    roll_state = lambda t: SSMMState(*[roll1(x) for x in t])

    curr = _state_new(n, dev)
    tent = _state_new(n, dev)
    sample_dirs, sample_weights, vmf_mus, vmf_kappas = [], [], [], []

    for _ in range(config.spp):
        tent = roll_state(tent)

        # ---- read_neighbour_state (ssmm.comp:99-121) ----
        base_x = pxf.to(torch.float32) + mv[:, 0]
        base_y = pyf.to(torch.float32) + mv[:, 1]
        bxi, byi = _to_int(base_x), _to_int(base_y)
        bx = torch.clamp(bxi, 0, W - 1)
        by = torch.clamp(byi, 0, H - 1)
        score_sum = _state_score(
            tent, surf.pos, surf.normal, normal_img, z_img, cam_x, layout.index_of(bx, by, W, H),
        )
        for _ in range(scfg.smis_group_size):
            rng, u12 = rng_ops.uniform4(rng)
            rng, u34 = rng_ops.uniform4(rng)
            rng, u56 = rng_ops.uniform4(rng)
            tentu = (
                u12[:, 0:2] + u12[:, 2:4] + u34[:, 0:2] + u34[:, 2:4]
                + u56[:, 0:2] + u56[:, 2:4]
            )
            off = torch.floor(15.0 * (tentu - 3.0)).to(torch.int64)
            rng, u_rep = rng_ops.uniform(rng)
            ox = torch.clamp(bxi + off[:, 0], 0, W - 1)
            oy = torch.clamp(byi + off[:, 1], 0, H - 1)
            oidx = layout.index_of(ox, oy, W, H)
            cand = SSMMState(*[x[oidx] for x in sstate_full])
            other = _state_score(cand, surf.pos, surf.normal, normal_img, z_img, cam_x, oidx)
            take = (score_sum <= 0.0) | (u_rep < other / (other + score_sum))
            tent = _sel(take, cand, tent)
            score_sum = score_sum + other

        tent_valid = tent.sum_w > 0.0
        mu, kappa = _state_vmf(tent, surf.pos, scfg)
        kappa = torch.where(tent_valid, kappa, 0.0)

        # ---- sample direction (vMF or defensive BSDF) ----
        rng, u_b = rng_ops.uniform(rng)
        use_bsdf = (kappa == 0.0) | (u_b < scfg.surf_bsdf_p)
        rng, u3 = rng_ops.uniform3(rng)
        wo_b = bsdf.sample(surf.wi, surf.normal, alpha_r, u3)
        rng, u2 = rng_ops.uniform2(rng)
        wo_g = vmf.sample(mu, torch.clamp_min(kappa, 1e-6), u2)
        wo = torch.where(use_bsdf[..., None], wo_b, wo_g)
        below = (linalg.dot(wo, surf.normal) <= 1e-3) | (linalg.dot(wo, surf.geo_normal) <= 1e-3)
        ok = live & ~(use_bsdf & below)  # bsdf below-horizon breaks out
        ok = ok & ~below

        pdf_val = torch.where(
            use_bsdf,
            bsdf.pdf(surf.wi, wo, surf.normal, alpha_r),
            vmf.pdf(wo, mu, torch.clamp_min(kappa, 1e-6)),
        )
        micro = bsdf.eval_times_cos(surf.wi, wo, surf.normal, alpha_r)

        # every lane traces, as the reference's does; the rays go as they
        # lie unless the schedule sorts them by its target key
        origin = surf.pos - surf.wi * 1e-3
        res = trace_ray(
            accel, atlas, uniforms, origin, wo,
            bilinear=config.bilinear, features=config.features,
            sort_rays=sorts_bounce_rays(schedule), schedule=schedule,
        )
        incident = res.contribution
        position = res.hit.pos

        direct = torch.where(
            (ok & (pdf_val > 0.0))[..., None],
            micro[..., None] * incident / torch.clamp_min(pdf_val, 1e-20)[..., None],
            0.0,
        )
        weight = torch.where(ok[..., None], micro[..., None] * incident, 0.0)
        sample_dirs.append(torch.where(ok[..., None], wo, 0.0))
        sample_weights.append(weight)
        vmf_mus.append(mu)
        vmf_kappas.append(kappa)

        # ---- Metropolis acceptance (ssmm.comp:196-206) ----
        tent_f = color_ops.yuv_luminance(direct)
        rng, u_acc = rng_ops.uniform(rng)
        accept = ok & ((curr.f == 0.0) | (u_acc < tent_f / torch.clamp_min(curr.f, 1e-30)))
        fresh = _state_new(n, dev)
        tent_base = _sel(accept & use_bsdf, fresh, tent)
        tent_acc = tent_base._replace(f=torch.where(accept, tent_f, tent_base.f))
        added_acc = _state_add(tent_acc, surf.pos, tent_f, wo, position, scfg)
        # rejected vMF samples still update the tentative chain
        added_rej = _state_add(tent, surf.pos, tent_f, wo, position, scfg)
        keep_rej = ok & ~accept & ~use_bsdf
        tent = _sel(accept, added_acc, _sel(keep_rej, added_rej, tent))
        curr = _sel(accept, tent, curr)

    # ---- SMIS estimator (ssmm.comp:209-229) ----
    irr = torch.zeros((n, 3), device=dev)
    m1 = torch.zeros((n,), device=dev)
    m2 = torch.zeros((n,), device=dev)
    for s in range(config.spp):
        w_s = sample_weights[s]
        nonzero = (w_s != 0.0).any(-1)
        bsdf_p = bsdf.pdf(surf.wi, sample_dirs[s], surf.normal, alpha_r)
        sum_pdf = torch.zeros((n,), device=dev)
        for t in range(config.spp):
            p_t = torch.where(
                vmf_kappas[t] > 0.0,
                vmf.pdf(sample_dirs[s], vmf_mus[t], torch.clamp_min(vmf_kappas[t], 1e-6)),
                bsdf_p,
            )
            sum_pdf = sum_pdf + p_t
        sum_pdf = (
            scfg.surf_bsdf_p * scfg.smis_group_size * bsdf_p
            + (1.0 - scfg.surf_bsdf_p) * sum_pdf
        )
        con = torch.where(
            (nonzero & (sum_pdf > 0.0))[..., None],
            w_s / torch.clamp_min(sum_pdf, 1e-30)[..., None],
            0.0,
        )
        finite = torch.isfinite(con).all(-1)
        con = torch.where(finite[..., None], con, 0.0)
        irr = irr + con
        l = color_ops.yuv_luminance(con)
        m1 = m1 + l
        m2 = m2 + l * l

    # persist only for live pixels (ssmm.comp:232)
    new_state = _sel(live, curr, sstate)

    img = layout.flat_to_image(torch.cat([irr, m2[..., None]], dim=-1), W, rows)
    return img, new_state
