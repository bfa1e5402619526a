"""Quake 8-bit palette handling.

The real palette ships in the game data (gfx/palette.lmp, 768 bytes) —
pass its bytes to :func:`palette_from_lmp`. Without game data we use a
procedural stand-in with the same STRUCTURE: 13 ramps of 16 entries,
indices 224..254 fullbright (emissive in the renderer, quakespasm
gl_texmgr convention), index 255 transparent for '{'-prefixed fence
textures.

Copy of merian_quake_tpu/models/palette.py (jax-free numpy).
"""
from __future__ import annotations

import numpy as np

FULLBRIGHT_START = 224
TRANSPARENT_INDEX = 255


def default_palette() -> np.ndarray:
    """Procedural 256×3 uint8 palette (structural stand-in)."""
    ramps = [
        ((20, 20, 20), (235, 235, 235)),  # greys
        ((25, 18, 10), (200, 160, 110)),  # browns
        ((30, 25, 40), (150, 140, 200)),  # blue-greys
        ((15, 30, 15), (120, 190, 120)),  # greens
        ((40, 20, 15), (210, 120, 80)),  # skin/wood
        ((35, 12, 12), (220, 80, 60)),  # reds
        ((30, 22, 8), (230, 190, 90)),  # golds
        ((10, 18, 30), (90, 140, 220)),  # blues
        ((22, 12, 25), (180, 110, 190)),  # purples
        ((12, 25, 28), (110, 200, 210)),  # teals
        ((28, 28, 12), (210, 210, 100)),  # yellows
        ((18, 10, 6), (140, 90, 60)),  # dark browns
        ((26, 16, 20), (200, 140, 160)),  # pinks
        ((35, 28, 16), (255, 220, 140)),  # fullbright golds
        ((40, 16, 8), (255, 140, 60)),  # fullbright oranges (fire)
        ((45, 40, 30), (255, 255, 215)),  # fullbright whites
    ]
    pal = np.zeros((256, 3), np.uint8)
    for r, (lo, hi) in enumerate(ramps):
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        for i in range(16):
            t = i / 15.0
            pal[r * 16 + i] = (lo + (hi - lo) * t).astype(np.uint8)
    pal[TRANSPARENT_INDEX] = (159, 91, 83)
    return pal


def palette_from_lmp(data: bytes) -> np.ndarray:
    if len(data) < 768:
        raise ValueError("palette.lmp must be 768 bytes")
    return np.frombuffer(data[:768], np.uint8).reshape(256, 3).copy()


def indexed_to_rgba(
    pixels: np.ndarray, palette: np.ndarray, fence: bool = False
) -> np.ndarray:
    """8-bit indexed image → RGBA. Fence textures map index 255 to
    alpha 0 (quakespasm TEXPREF_ALPHA for '{' textures)."""
    rgba = np.zeros(pixels.shape + (4,), np.uint8)
    rgba[..., :3] = palette[pixels]
    rgba[..., 3] = 255
    if fence:
        rgba[pixels == TRANSPARENT_INDEX] = 0
    return rgba


def fullbright_mask(pixels: np.ndarray) -> np.ndarray:
    """True where the texel is emissive (indices 224..254)."""
    return (pixels >= FULLBRIGHT_START) & (pixels != TRANSPARENT_INDEX)
