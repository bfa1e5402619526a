"""Pixel ↔ flat-buffer layout (tile-major order).

Port of merian_quake_tpu/render/layout.py: 8×128 pixel tiles keep
consecutive rays (one intersection block) angularly close. Resolutions
not divisible by the tile size fall back to scanline order.
"""
from __future__ import annotations

import torch

TILE_H = 8
TILE_W = 128


def is_tiled(width: int, height: int) -> bool:
    return width % TILE_W == 0 and height % TILE_H == 0


def gen_pixels(width: int, height: int, device="cuda"):
    """Flat (px, py) int32 tensors in buffer order: tile-major where the
    image tiles."""
    ar = lambda k: torch.arange(k, dtype=torch.int32, device=device)
    if not is_tiled(width, height):
        py, px = torch.meshgrid(ar(height), ar(width), indexing="ij")
        return px.reshape(-1), py.reshape(-1)
    nty, ntx = height // TILE_H, width // TILE_W
    ty = ar(nty).reshape(nty, 1, 1, 1)
    tx = ar(ntx).reshape(1, ntx, 1, 1)
    iy = ar(TILE_H).reshape(1, 1, TILE_H, 1)
    ix = ar(TILE_W).reshape(1, 1, 1, TILE_W)
    shape = (nty, ntx, TILE_H, TILE_W)
    px = (tx * TILE_W + ix).expand(shape)
    py = (ty * TILE_H + iy).expand(shape)
    return px.reshape(-1), py.reshape(-1)


def flat_to_image(x: torch.Tensor, width: int, height: int):
    """Flat buffer (N, ...) → image (H, W, ...)."""
    if not is_tiled(width, height):
        return x.reshape((height, width) + tuple(x.shape[1:]))
    nty, ntx = height // TILE_H, width // TILE_W
    t = x.reshape((nty, ntx, TILE_H, TILE_W) + tuple(x.shape[1:]))
    order = (0, 2, 1, 3) + tuple(range(4, t.dim()))
    return t.permute(order).reshape((height, width) + tuple(x.shape[1:]))


def image_to_flat(img: torch.Tensor, width: int, height: int):
    """Image (H, W, ...) → flat buffer (N, ...)."""
    if not is_tiled(width, height):
        return img.reshape((height * width,) + tuple(img.shape[2:]))
    nty, ntx = height // TILE_H, width // TILE_W
    t = img.reshape((nty, TILE_H, ntx, TILE_W) + tuple(img.shape[2:]))
    order = (0, 2, 1, 3) + tuple(range(4, t.dim()))
    return t.permute(order).reshape((height * width,) + tuple(img.shape[2:]))


def index_of(px, py, width: int, height: int):
    """Pixel coords (int tensors) → flat buffer index."""
    if not is_tiled(width, height):
        return py * width + px
    ntx = width // TILE_W
    ty, iy = py // TILE_H, py % TILE_H
    tx, ix = px // TILE_W, px % TILE_W
    return ((ty * ntx + tx) * TILE_H + iy) * TILE_W + ix
