"""MCPG debug visualizations.

Port of merian_quake_tpu/render/mcpg/debug.py: the 9 debug output
selectors of the reference's mcpg.comp:212-277 (compiled in when the
debug image connector is attached). Each view inspects the learned
guiding state at the FIRST HIT of every pixel:

  0  light cache irradiance ×5
  1  adaptive MC learned irradiance (sum_w × 0.1)
  2  adaptive MC learned direction ((vMF μ + 1)/2)
  3  adaptive MC grid cells (random OKLCh color per cell hash,
     lightness modulated by camera distance)
  4  path irradiance
  5  (luminance, second moment, 0)
  6  adaptive MC learned mean cosine (1 − acos(w_cos/sum_w)/π)
  7  adaptive MC chain length N / ML_MAX_N
  8  adaptive MC state velocity (mv)

The views read the first hits in flat buffer order and the irradiance
image through ``layout.image_to_flat``; the JAX package reshapes the
irradiance image as if it were the buffer, which is the same order only
where the size does not tile (ROADMAP queue 3).
"""
from __future__ import annotations

import math

import torch

from ...models.types import RenderConfig, Uniforms
from ...ops import color as color_ops, hashgrid, linalg, rng as rng_ops
from .. import layout
from ..gbuffer import GBufferOutput
from ..hit import decompress_hit
from . import grids
from .config import MCPGConfig, MCPGState
from .light_cache import lc_get

DEBUG_VIEWS = {
    0: "light cache",
    1: "MC learned irradiance",
    2: "MC learned directions",
    3: "MC grid",
    4: "irradiance",
    5: "moments",
    6: "MC learned cos",
    7: "MC N",
    8: "MC MV",
}


def grid_cell_seed(pos, cam_x, mcfg: MCPGConfig) -> torch.Tensor:
    """View 3's cell key: the 16-bit verification hash of the closest
    adaptive cell at the deterministic target level (u32 in int64)."""
    level = grids.adaptive_target_level(pos, cam_x, mcfg)
    width = grids._adaptive_width_for_level(level, mcfg)
    idx = hashgrid.grid_idx_closest(pos, width[..., None])
    return hashgrid.hash2_grid(idx)


def render_mcpg_debug(
    selector: int,
    uniforms: Uniforms,
    config: RenderConfig,
    mcfg: MCPGConfig,
    mstate: MCPGState,
    gbuf: GBufferOutput,
    irradiance: torch.Tensor,  # f32[H, W, 4] surface pass output
) -> torch.Tensor:
    """One debug view as f32[H, W, 3] (mcpg.comp:212-277)."""
    W, H = config.width, config.height
    first_hit = decompress_hit(gbuf.hits)
    pos, normal = first_hit.pos, first_hit.normal
    cam_x = uniforms.cam_x
    flat = layout.image_to_flat(irradiance, W, H)
    irr = flat[:, :3]
    m2 = flat[:, 3]

    pxi, pyi = layout.gen_pixels(W, H, device=pos.device)
    rng = rng_ops.seed_pixel(pxi, pyi, uniforms.frame, config.seed ^ 0xDEB)

    if selector == 0:
        # -- show light cache --
        rng, lc_irr = lc_get(rng, mstate.lc, pos, normal, cam_x, mcfg)
        out = lc_irr * 5.0
    elif selector in (1, 2, 6, 7, 8):
        # adaptive load at the first hit (mc_adaptive_load)
        rng, buf, h = grids.adaptive_cell(rng, pos, normal, cam_x, mcfg)
        st = grids.gather_state(mstate.mc, buf)
        st = grids.finalize_load(st, h, uniforms.cl_time)
        if selector == 1:
            out = (st.sum_w * 0.1)[:, None].expand(pos.shape)
        elif selector == 2:
            mu, _ = grids.state_vmf(st, pos, mcfg)
            out = (mu + 1.0) * 0.5
        elif selector == 6:
            have = st.sum_w > 0.0
            ratio = torch.clamp(
                st.w_cos / torch.where(have, st.sum_w, 1.0), -1.0, 1.0
            )
            v = torch.where(
                have,
                1.0 - torch.clamp(torch.arccos(ratio) / math.pi, 0.0, 1.0),
                0.0,
            )
            out = v[:, None].expand(pos.shape)
        elif selector == 7:
            out = (st.N.to(torch.float32) / mcfg.ml_max_n)[:, None].expand(pos.shape)
        else:
            out = st.mv
    elif selector == 3:
        # -- MC grid: random OKLCh color per closest cell at the
        # deterministic target level (mcpg.comp:237-241) --
        seed = grid_cell_seed(pos, cam_x, mcfg)
        s1 = rng_ops.xorshift32_raw(torch.clamp_min(seed, 1))
        s2 = rng_ops.xorshift32_raw(s1)
        # the colour in f64, rounded once to f32: the card's and the CPU's
        # f32 exp, cos and sin (and their sums of three squares) differ in
        # the last bit, while their f64 results round to the same f32
        # colour (the draws u1, u2 are the JAX package's f32 values)
        u1 = s1.to(torch.float32).double() / 4294967296.0
        u2 = s2.to(torch.float32).double() / 4294967296.0
        dist = linalg.distance(cam_x.double(), pos.double())
        L = torch.exp(-0.001 * dist) * u1 + 0.2
        lch = torch.stack(
            [L, torch.full_like(L, 0.2), 2.0 * math.pi * u2], dim=-1
        )
        out = color_ops.oklch_to_rgb(lch).float()
    elif selector == 4:
        out = irr
    elif selector == 5:
        out = torch.stack(
            [color_ops.yuv_luminance(irr), m2, torch.zeros_like(m2)], dim=-1
        )
    else:
        raise ValueError(f"unknown debug selector {selector} "
                         f"(valid: {sorted(DEBUG_VIEWS)})")
    return layout.flat_to_image(out, W, H)
