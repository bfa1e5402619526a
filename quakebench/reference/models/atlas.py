"""Texture atlas: host-side packing (numpy) + device-side sampling (torch).

Port of merian_quake_tpu/models/atlas.py: one big 2D atlas plus a rect
table, sampled with gathers. sRGB decode and the reference's pow(1/1.2)
albedo transform are folded in at pack time.
"""
from __future__ import annotations

import numpy as np
import torch

from . import materials
from .types import TextureAtlas


def _srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    """numpy twin of ops.color.srgb_to_linear, in float32."""
    c = np.clip(c, 0.0, 1.0).astype(np.float32)
    lin = np.power(
        (c + np.float32(0.055)) / np.float32(1.055), np.float32(2.4)
    )
    return np.where(c <= 0.04045, c / np.float32(12.92), lin).astype(
        np.float32
    )


def pack_textures(
    textures: list[np.ndarray],
    srgb: list[bool] | None = None,
    max_textures: int = materials.MAX_GLTEXTURES,
    mip_levels: int = 4,
    device="cuda",
) -> TextureAtlas:
    """Shelf-pack RGBA uint8 (or float) textures into one atlas.

    ``textures[i]`` becomes texture id i (id 0 should be a 1×1 white
    dummy). Returns a TextureAtlas with linear float32 data on ``device``.
    """
    if len(textures) == 0:
        textures = [np.full((1, 1, 4), 255, np.uint8)]
    if len(textures) > max_textures:
        raise ValueError(f"{len(textures)} textures > {max_textures}")
    if srgb is None:
        srgb = [True] * len(textures)

    norm = []
    for t, is_srgb in zip(textures, srgb):
        t = np.asarray(t)
        if t.ndim == 2:
            t = t[..., None].repeat(4, axis=-1)
        if t.shape[-1] == 3:
            t = np.concatenate([t, np.full(t.shape[:-1] + (1,), 255, t.dtype)], -1)
        if t.dtype == np.uint8:
            t = t.astype(np.float32) / 255.0
        t = t.astype(np.float32)
        if is_srgb:
            rgb = _srgb_to_linear_np(t[..., :3])
            # reference samples textures then applies pow(1/1.2)
            rgb = np.power(np.clip(rgb, 0.0, 1.0), 1.0 / 1.2)
            t = np.concatenate([rgb, t[..., 3:4]], -1).astype(np.float32)
        norm.append(t)

    # Shelf packing, tallest first (stable order preserved via index
    # sort). Rects are aligned to 2^mip_levels so downsampled levels
    # never bleed across texture boundaries.
    align = 1 << mip_levels
    order = sorted(range(len(norm)), key=lambda i: -norm[i].shape[0])
    atlas_w = 1
    total_area = sum(t.shape[0] * t.shape[1] for t in norm)
    while atlas_w * atlas_w < total_area * 1.3:
        atlas_w *= 2
    atlas_w = max(atlas_w, max(t.shape[1] for t in norm))
    w = 1
    while w < atlas_w:
        w *= 2
    atlas_w = w

    up = lambda v: -(-v // align) * align
    table = np.zeros((max_textures, 4), np.int32)
    placements = {}
    x = y = shelf_h = 0
    for i in order:
        t = norm[i]
        th, tw = t.shape[:2]
        if x + up(tw) > atlas_w:
            y += up(shelf_h)
            x = 0
            shelf_h = 0
        placements[i] = (x, y)
        table[i] = (x, y, tw, th)
        shelf_h = max(shelf_h, th)
        x += up(tw)
    atlas_h = y + up(shelf_h)
    atlas_h = max(-(-atlas_h // 8) * 8, align)

    data = np.zeros((atlas_h, atlas_w, 4), np.float32)
    for i, t in enumerate(norm):
        px, py = placements[i]
        data[py : py + t.shape[0], px : px + t.shape[1]] = t

    # mip chain by 2x2 box filter of the aligned atlas
    mips = []
    cur = data
    for _ in range(mip_levels):
        h2, w2 = cur.shape[0] // 2, cur.shape[1] // 2
        if h2 < 1 or w2 < 1:
            break
        cur = cur[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, 4).mean((1, 3))
        mips.append(cur.astype(np.float32))

    flat = np.concatenate([data.reshape(-1, 4)] + [m.reshape(-1, 4) for m in mips])
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return TextureAtlas(
        data=dev(data),
        table=dev(table),
        mips=tuple(dev(m) for m in mips),
        flat=dev(flat),
    )


def _rect(atlas: TextureAtlas, texnum):
    idx = torch.clamp(texnum.long(), 0, atlas.table.shape[0] - 1)
    # index_select, not table[idx]: indexing with a 0-d device tensor
    # reads it back to the host and stalls the stream
    rect = atlas.table.index_select(0, idx.reshape(-1)).reshape(idx.shape + (4,))
    return rect[..., 0], rect[..., 1], rect[..., 2], rect[..., 3]


def _gather_texels(atlas: TextureAtlas, tx, ty):
    flat = atlas.data.reshape(-1, 4)
    idx = ty.long() * atlas.width + tx.long()
    return flat[idx]


def sample_nearest(atlas: TextureAtlas, texnum, uv):
    """Point-sample with GL_REPEAT wrap. texnum i32[...], uv f32[..., 2]."""
    x, y, w, h = _rect(atlas, texnum)
    w = torch.clamp_min(w, 1)
    h = torch.clamp_min(h, 1)
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    tx = x + torch.minimum(torch.clamp_min((u * w).to(torch.int32), 0), w - 1)
    ty = y + torch.minimum(torch.clamp_min((v * h).to(torch.int32), 0), h - 1)
    return _gather_texels(atlas, tx, ty)


def sample_bilinear(atlas: TextureAtlas, texnum, uv):
    """Bilinear sample with GL_REPEAT wrap within the texture's rect."""
    x, y, w, h = _rect(atlas, texnum)
    w = torch.clamp_min(w, 1)
    h = torch.clamp_min(h, 1)
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    fx = u * w.float() - 0.5
    fy = v * h.float() - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]

    def _wrap(c, n):
        # floor-mod, like jnp.mod on int32
        return torch.remainder(c.to(torch.int32), n)

    x0i = _wrap(x0, w)
    x1i = _wrap(x0 + 1, w)
    y0i = _wrap(y0, h)
    y1i = _wrap(y0 + 1, h)
    c00 = _gather_texels(atlas, x + x0i, y + y0i)
    c10 = _gather_texels(atlas, x + x1i, y + y0i)
    c01 = _gather_texels(atlas, x + x0i, y + y1i)
    c11 = _gather_texels(atlas, x + x1i, y + y1i)
    top = c00 * (1 - ax) + c10 * ax
    bot = c01 * (1 - ax) + c11 * ax
    return top * (1 - ay) + bot * ay


def sample_mip(atlas: TextureAtlas, texnum, uv, lod):
    """Nearest-mip sampling by per-ray level of detail: ONE gather from
    the concatenated flat mip chain (per-level offsets and strides come
    from the level shapes)."""
    levels = atlas.num_levels
    if levels == 1 or atlas.flat is None:
        return sample_nearest(atlas, texnum, uv)
    li = torch.clamp(torch.round(lod).to(torch.int32), 0, levels - 1)
    rx, ry, rw, rh = _rect(atlas, texnum)
    x = rx >> li
    y = ry >> li
    w = torch.clamp_min(rw >> li, 1)
    h = torch.clamp_min(rh >> li, 1)
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    tx = x + torch.minimum(torch.clamp_min((u * w.float()).to(torch.int32), 0), w - 1)
    ty = y + torch.minimum(torch.clamp_min((v * h.float()).to(torch.int32), 0), h - 1)

    shapes = [atlas.data.shape] + [m.shape for m in atlas.mips]
    off = 0
    off_l = torch.zeros_like(li, dtype=torch.int64)
    stride_l = torch.full_like(li, shapes[0][1], dtype=torch.int64)
    for l, s in enumerate(shapes):
        if l > 0:
            off_l = torch.where(li == l, off, off_l)
            stride_l = torch.where(li == l, s[1], stride_l)
        off += s[0] * s[1]
    idx = off_l + ty.long() * stride_l + tx.long()
    return atlas.flat[idx]


def sample(atlas: TextureAtlas, texnum, uv, bilinear: bool = True):
    if bilinear:
        return sample_bilinear(atlas, texnum, uv)
    return sample_nearest(atlas, texnum, uv)
