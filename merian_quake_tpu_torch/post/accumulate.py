"""Temporal accumulation (port of merian_quake_tpu/post/accumulate.py,
single device): the cumulative average, and the motion-vector
reprojected accumulation the volume pass's history takes."""
from __future__ import annotations

import torch

from ..ops import color as color_ops
from ..ops.linalg import as_f32


def accumulate(history, new, iteration, alpha=0.0):
    """history, new: f32[H, W, C]; iteration: 0-based frame counter, a
    device scalar (as the frame state carries it) or a Python int.
    ``alpha == 0`` gives the cumulative average; otherwise an
    exponentially weighted average with warm-up 1/(iteration + 1). The
    weight is the JAX package's f32 1 / (it + 1), computed on the
    device: no host read."""
    w_new = 1.0 / (as_f32(iteration, history) + 1.0)
    if alpha > 0.0:
        w_new = torch.clamp_min(w_new, float(alpha))
    return history + (new - history) * w_new


def firefly_clamp(img, k=4.0):
    """Percentile-style firefly filter: clamp each pixel's luminance
    against its 3×3 neighborhood mean + k·std."""
    lum = color_ops.yuv_luminance(img[..., :3])
    H, W = lum.shape
    s1 = torch.zeros_like(lum)
    s2 = torch.zeros_like(lum)
    cnt = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            ys = torch.clamp(torch.arange(H, device=lum.device) + dy, 0, H - 1)
            xs = torch.clamp(torch.arange(W, device=lum.device) + dx, 0, W - 1)
            v = lum[ys][:, xs]
            s1 = s1 + v
            s2 = s2 + v * v
            cnt += 1
    mean = s1 / cnt
    std = torch.sqrt(torch.clamp_min(s2 / cnt - mean * mean, 0.0))
    limit = mean + k * std + 1e-4
    scale = torch.clamp_max(limit / torch.clamp_min(lum, 1e-8), 1.0)
    return torch.cat([img[..., :3] * scale[..., None], img[..., 3:]], dim=-1)


def accumulate_reprojected(history, hist_len, new, mv, valid_extra=None, alpha=0.0,
                           firefly_k=0.0, gather_fn=lambda x: x, y0=0, rows=None):
    """Accumulate with motion-vector reprojection (merian Accumulate).

    history/new: f32[H, W, C]; hist_len: f32[H, W]; mv: f32[H, W, 2];
    valid_extra: optional bool[H, W] additional reprojection gate.
    Returns (accumulated, new_hist_len).

    ``gather_fn``/``y0``/``rows``: the row-slab variant. The history slab
    is gathered to full height (post.sharded.ShardCtx.gather_rows) and
    reprojected with global row indices, so a slab's result is the
    single-device result's rows.
    """
    if firefly_k > 0.0:
        new = firefly_clamp(new, firefly_k)
    prev, valid = reproject(gather_fn(history), mv, y0=y0, rows=rows)
    if valid_extra is not None:
        valid = valid & valid_extra
    n = torch.where(valid, hist_len, 0.0) + 1.0
    w_new = torch.clamp_min(1.0 / n, float(alpha))
    out = torch.where(valid[..., None], prev + (new - prev) * w_new[..., None], new)
    return out, n


def _cell(s, hi: int):
    """floor(s) as an index clipped to [0, hi]. The clip comes before the
    integer conversion, so that a coordinate far off the image (or NaN,
    read as 0) converts like the JAX package's saturating one."""
    f = torch.nan_to_num(torch.floor(s), nan=0.0)
    return torch.clamp(f, 0.0, float(hi)).to(torch.int64)


def reproject(history, mv, fallback=None, y0=0, rows=None):
    """Bilinear history lookup at pixel + mv (mv in pixels, prev - cur).

    Out-of-bounds samples fall back to ``fallback`` (or the caller handles
    them through the returned validity). Returns (reprojected, valid).
    ``y0``/``rows``: evaluate only image rows [y0, y0 + rows) of a
    full-height ``history`` (``mv`` and ``fallback`` are that slab's), by
    global row.
    """
    H, W = history.shape[:2]
    rows = H if rows is None else rows
    dev = history.device
    py, px = torch.meshgrid(
        torch.arange(rows, dtype=torch.float32, device=dev) + float(y0),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    sx = px + mv[..., 0]
    sy = py + mv[..., 1]
    valid = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    x0 = _cell(sx, W - 1)
    y0 = _cell(sy, H - 1)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    ax = (sx - x0.to(torch.float32))[..., None]
    ay = (sy - y0.to(torch.float32))[..., None]
    g = lambda yy, xx: history[yy, xx]
    top = g(y0, x0) * (1 - ax) + g(y0, x1) * ax
    bot = g(y1, x0) * (1 - ax) + g(y1, x1) * ax
    out = top * (1 - ay) + bot * ay
    if fallback is not None:
        out = torch.where(valid[..., None], out, fallback)
    return out, valid
