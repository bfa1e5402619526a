"""The SSMM pass of the reference: upstream merian-quake's
``res/shader/render_ssmm/ssmm.comp`` (defaults ``render_ssmm.hpp:84-95``)
in plain float32 torch, one image on one device.

It follows the shader as the JAX package's ``render/ssmm/ssmm.py``
transcribes it. Where it departs from the shader:

- The subgroup shuffle that passes each lane's tentative chain to the
  next lane is a roll by one over the flat pixel buffer, in buffer order
  (tile-major where the image tiles, ``render/layout.py``): the last
  pixel's chain wraps to the first, and chains cross tile and subgroup
  borders, which a subgroup's shuffle never does.
- The gbuffer's hits are read as the compressed records the gbuffer
  writes (``decompress_hit``); the shader's layout declares uncompressed
  records over the same buffer.
- Every lane traces its bounce ray, live or not; a dead lane's
  contribution and chain update are masked out afterwards.
- ``int()`` of the motion vector's target truncates toward zero and, as
  XLA's conversion does, reads NaN as 0 and saturates at the int32 range
  (``_to_int``).
- The states are a structure of arrays over pixels (``SSMMState``), not
  an array of ``SSMCState`` records; the previous frame's are read from
  the state given, the frame's are a new one.
- The random numbers come from ``ops/rng.py``'s chain a pixel, drawn in
  the JAX package's order.
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
    """SSMCState (ssmc_state.h) as a structure of arrays over pixels."""

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
    """mc_state_add (ssmm.comp:47-57), in the shader's order of updates."""
    n_new = torch.clamp_max(s.N + 1, cfg.ml_max_n)
    alpha = torch.clamp_min(1.0 / torch.clamp_min(n_new, 1), cfg.ml_min_alpha)
    sum_w = s.sum_w + (w - s.sum_w) * alpha
    sum_tgt = s.sum_tgt + (w[..., None] * y - s.sum_tgt) * alpha[..., None]
    mid = s._replace(N=n_new, sum_w=sum_w, sum_tgt=sum_tgt)
    to = s.sum_len[..., None] * _state_dir(mid, x)
    to = to + (w[..., None] * direction - to) * alpha[..., None]
    return mid._replace(sum_len=linalg.norm(to))


def _state_vmf(s: SSMMState, x, cfg: SSMMConfig):
    """The chain's lobe: its direction and concentration, the mean cosine
    shrunk by the prior (mc_state_get_vmf)."""
    r = s.sum_len / torch.where(s.sum_w > 0.0, s.sum_w, 1.0)
    n2 = (s.N * s.N).to(torch.float32)
    r = torch.clamp(n2 * r / (n2 + cfg.ml_prior_n), 0.0, 0.9999999)
    return _state_dir(s, x), vmf.kappa_from_mean_cos(r)


def _state_score(s: SSMMState, x, nx, normal_img, z_img, cam_x, idx):
    """f × the SVGF-style compatibility of the pixel at ``idx``
    (mc_state_C, ssmm.comp:76-97)."""
    nq = normal_img[idx]
    zq = z_img[idx]
    w_n = torch.pow(torch.clamp_min(linalg.dot(nx, nq), 0.0), 64.0)
    w_d = torch.exp(-(zq - linalg.distance(x, cam_x)).abs() / 10.0)
    return s.f * w_n * w_d


def _to_int(s):
    """``int()`` of a float: truncation toward zero, saturating at the
    int32 range, NaN read as 0; kept in int64, so that adding a jitter
    offset to a saturated value cannot wrap."""
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
):
    """The SSMM pass over the image. Returns (irradiance f32[H, W, 4]: rgb
    and the second moment of the luminance, the new SSMMState).
    ``schedule`` sorts the bounce rays where it would on the card; no
    schedule changes a hit."""
    W, H = config.width, config.height
    n = W * H
    dev = accel.tri_attr.device
    pxf, pyf = layout.gen_pixels(W, H, device=dev)
    rng = rng_ops.seed_pixel(pxf, pyf, uniforms.frame, config.seed)

    surf = decompress_hit(gbuf.hits)
    live = (surf.albedo >= 1e-7).any(-1)
    normal_img = layout.image_to_flat(gbuf.normal, W, H)
    z_img = layout.image_to_flat(gbuf.linear_z, W, H)
    mv = layout.image_to_flat(gbuf.mv, W, H)
    cam_x = uniforms.cam_x
    alpha_r = bsdf.roughness_to_alpha(surf.roughness)
    roll_state = lambda t: SSMMState(*[torch.roll(x, 1, 0) for x in t])

    curr = _state_new(n, dev)
    tent = _state_new(n, dev)
    sample_dirs, sample_weights, vmf_mus, vmf_kappas = [], [], [], []

    for _ in range(config.spp):
        # the subgroup shuffle: each tentative chain one lane on
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
            # a tent-distributed jitter of ±15 px: the sum of six uniforms
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
            cand = SSMMState(*[x[oidx] for x in sstate])
            other = _state_score(cand, surf.pos, surf.normal, normal_img, z_img, cam_x, oidx)
            # weighted reservoir replacement by score
            take = (score_sum <= 0.0) | (u_rep < other / (other + score_sum))
            tent = _sel(take, cand, tent)
            score_sum = score_sum + other

        tent_valid = tent.sum_w > 0.0
        mu, kappa = _state_vmf(tent, surf.pos, scfg)
        kappa = torch.where(tent_valid, kappa, 0.0)

        # ---- the direction: the chain's vMF lobe or the defensive BSDF ----
        rng, u_b = rng_ops.uniform(rng)
        use_bsdf = (kappa == 0.0) | (u_b < scfg.surf_bsdf_p)
        rng, u3 = rng_ops.uniform3(rng)
        wo_b = bsdf.sample(surf.wi, surf.normal, alpha_r, u3)
        rng, u2 = rng_ops.uniform2(rng)
        wo_g = vmf.sample(mu, torch.clamp_min(kappa, 1e-6), u2)
        wo = torch.where(use_bsdf[..., None], wo_b, wo_g)
        below = (linalg.dot(wo, surf.normal) <= 1e-3) | (linalg.dot(wo, surf.geo_normal) <= 1e-3)
        ok = live & ~(use_bsdf & below)  # a BSDF sample below the horizon breaks out
        ok = ok & ~below

        pdf_val = torch.where(
            use_bsdf,
            bsdf.pdf(surf.wi, wo, surf.normal, alpha_r),
            vmf.pdf(wo, mu, torch.clamp_min(kappa, 1e-6)),
        )
        micro = bsdf.eval_times_cos(surf.wi, wo, surf.normal, alpha_r)

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
        # a rejected vMF sample still updates the tentative chain
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

    # the chains persist only where a surface was hit (ssmm.comp:232)
    new_state = _sel(live, curr, sstate)

    img = layout.flat_to_image(torch.cat([irr, m2[..., None]], dim=-1), W, H)
    return img, new_state
