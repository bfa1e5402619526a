"""HUD overlay: health/armor bars, crosshair, screen blend, liquid tint.

Port of merian_quake_tpu/game/hud.py (the reference's src/hud/hud.comp):
draws translucent status bars bottom-left, a crosshair at the center,
mixes in the game's screen-blend color (damage/pickup flashes), and
applies a transmittance-based tint when the camera is underwater/lava/
slime using the gbuffer's linear depth. Torch ops on the source image's
device; the HUD's numbers are f32 as in the JAX package, computed on
the host in numpy's f32 and placed by device fills (no host-to-device
copy, so a frame with a HUD stays free of synchronizing calls).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class HudState(NamedTuple):
    health: float = 100.0
    armor: float = 0.0
    screen_blend: tuple = (0.0, 0.0, 0.0, 0.0)  # rgba flash
    liquid: int = 0  # 0 none, 1 water, 2 lava, 3 slime


_LIQUID_TINT = {
    1: (0.12, 0.25, 0.45),
    2: (0.9, 0.25, 0.05),
    3: (0.2, 0.5, 0.1),
}
_LIQUID_DENSITY = {1: 0.004, 2: 0.02, 3: 0.01}


def _vec(values, device) -> torch.Tensor:
    """f32[len(values)] on ``device``, made by fills."""
    return torch.stack([torch.full((), float(np.float32(v)), dtype=torch.float32, device=device)
                        for v in values])


def _bar(xx, yy, x0, y0, bar_w, bar_h, value):
    """(inside the bar, filled part) masks and the f32 fill fraction."""
    frac = np.clip(np.float32(value / 100.0), np.float32(0.0), np.float32(1.0))
    inside = (yy >= y0) & (yy < y0 + bar_h) & (xx >= x0) & (xx < x0 + bar_w)
    filled = inside & (xx < x0 + int(frac * np.float32(bar_w)))
    return inside, filled, frac


def apply_hud(ldr, linear_z, hud: HudState):
    """ldr: f32[H, W, 3]; linear_z: f32[H, W]. Returns composited image."""
    H, W = ldr.shape[:2]
    dev = ldr.device
    out = ldr

    # liquid tint: blend toward the tint with depth-based transmittance
    if hud.liquid in _LIQUID_TINT:
        tint = _vec(_LIQUID_TINT[hud.liquid], dev)
        trans = torch.exp(-_LIQUID_DENSITY[hud.liquid] * linear_z)[..., None]
        out = out * trans + tint * (1.0 - trans)

    # screen blend (damage flash etc.)
    br, bg, bb, ba = hud.screen_blend
    if ba > 0.0:
        out = out * (1.0 - ba) + _vec([br, bg, bb], dev) * ba

    yy, xx = torch.meshgrid(
        torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij"
    )

    # health bar (red→green), bottom-left (hud.comp bar layout)
    bar_w = W // 4
    bar_h = max(H // 48, 2)
    x0, y0 = W // 32, H - 3 * bar_h
    in_bar, filled, frac = _bar(xx, yy, x0, y0, bar_w, bar_h, hud.health)
    col = _vec([np.float32(1.0) - frac, frac, 0.05], dev)
    out = torch.where(filled[..., None], out * 0.25 + col * 0.75, out)
    out = torch.where((in_bar & ~filled)[..., None], out * 0.6 + 0.05, out)

    # armor bar above it
    if hud.armor > 0:
        y1 = y0 - 2 * bar_h
        in_ab, afilled, _ = _bar(xx, yy, x0, y1, bar_w, bar_h, hud.armor)
        out = torch.where(
            afilled[..., None], out * 0.25 + _vec([0.9, 0.75, 0.1], dev) * 0.75, out
        )
        out = torch.where((in_ab & ~afilled)[..., None], out * 0.6 + 0.05, out)

    # crosshair
    cx, cy = W // 2, H // 2
    arm = max(W // 160, 2)
    cross = (
        ((torch.abs(xx - cx) <= arm) & (torch.abs(yy - cy) == 0))
        | ((torch.abs(yy - cy) <= arm) & (torch.abs(xx - cx) == 0))
    )
    return torch.where(cross[..., None], 1.0 - out, out)
