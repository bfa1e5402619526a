"""Row-slab (multi-device) variants of the denoise chain, and the slab
context that every pass of a multi-device frame reads.

Port of merian_quake_tpu/post/sharded.py over ``torch.distributed``. A
frame is split into image-row slabs, one a rank (parallel/render.py).
The beauty-path post ops are image-space: à-trous taps reach ±2·step
rows, TAA/FXAA/variance estimates ±1, and temporal reprojection follows
unbounded motion vectors. The spatial taps are served by a HALO
EXCHANGE (each rank sends its boundary rows to its neighbours, the
JAX package's ``ppermute``) and the single-device op runs on the padded
slab, the halo cropped afterwards; the reprojection reads the GATHERED
previous-frame history with global row indices
(post.accumulate.reproject's ``y0``/``rows``).

The slab's result is the single-device result's rows by construction:
- interior slab borders: the halo rows are the neighbour's true rows;
- image borders: the halo replicates the edge row, which is the clamp of
  post.svgf._shift;
- reprojection: the same bilinear gather against the same full image.

Collectives: ``all_reduce`` (the exposure mean), ``all_gather`` (the
guiding queues, the gathered images) and point-to-point sends to the
neighbour ranks (the halos, SSMM's lane roll). The backend is the
caller's choice when the process group is made: NCCL for one card a
rank; gloo for CPU ranks and for ranks that share one card. Gloo takes
CUDA tensors for ``all_reduce`` only of these, so with gloo a CUDA
tensor goes through an explicit host copy for the gathers and the sends
(``ShardCtx.host_staged``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..ops import color as color_ops
from ..render import layout
from . import fxaa as fxaa_mod
from .accumulate import reproject
from .svgf import SVGFParams, SVGFState, _shift, atrous_iteration


class ShardCtx(NamedTuple):
    """This rank's row slab of a frame: rows [rank·rows, (rank+1)·rows)
    of an image ``height`` rows tall, split over ``n`` ranks of
    ``group`` (None: the default group)."""

    rank: int
    n: int
    rows: int
    height: int
    group: object = None
    host_staged: bool = False  # gloo: gathers and sends of CUDA tensors go through the host

    @classmethod
    def for_group(cls, rows: int, height: int, group=None) -> "ShardCtx":
        return cls(
            rank=dist.get_rank(group), n=dist.get_world_size(group), rows=rows,
            height=height, group=group, host_staged=dist.get_backend(group) == "gloo",
        )

    @property
    def y0(self) -> int:
        return self.rank * self.rows

    def _global(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def _out(self, x):
        """``x`` as this backend's collectives take it."""
        return x.cpu() if self.host_staged and x.is_cuda else x

    def mean(self, x):
        """The mean over ranks of one scalar (the JAX package's pmean):
        ``all_reduce`` of the sum, over n."""
        y = x.detach().clone().reshape(1)
        dist.all_reduce(y, group=self.group)
        return (y / self.n).reshape(x.shape)

    def all_gather(self, x):
        """Every rank's ``x``, stacked: (n, *x.shape)."""
        xs = self._out(x.contiguous())
        parts = [torch.empty_like(xs) for _ in range(self.n)]
        dist.all_gather(parts, xs, group=self.group)
        return torch.stack(parts).to(x.device)

    def _p2p(self, ops):
        """Post (tensor, peer rank, dist.isend | dist.irecv) together;
        wait for all of them."""
        works = dist.batch_isend_irecv(
            [dist.P2POp(op, t, self._global(peer), self.group) for t, peer, op in ops]
        )
        for w in works:
            w.wait()

    def halo_pad(self, x, r: int):
        """Pad a (rows, W[, C]) slab to (rows + 2r, W[, C]): interior
        borders receive the neighbour's true boundary rows, image borders
        replicate the edge row (the _shift clamp)."""
        assert 1 <= r <= self.rows, (r, self.rows)
        top, bot = self.rank == 0, self.rank == self.n - 1
        ops = []
        if not top:  # my first rows go up, the upper slab's last rows come down
            above = torch.empty_like(self._out(x[-r:]))
            ops += [(self._out(x[:r].contiguous()), self.rank - 1, dist.isend),
                    (above, self.rank - 1, dist.irecv)]
        if not bot:
            below = torch.empty_like(self._out(x[:r]))
            ops += [(self._out(x[-r:].contiguous()), self.rank + 1, dist.isend),
                    (below, self.rank + 1, dist.irecv)]
        if ops:
            self._p2p(ops)
        pad_top = x[:1].expand((r,) + tuple(x.shape[1:])) if top else above.to(x.device)
        pad_bot = x[-1:].expand((r,) + tuple(x.shape[1:])) if bot else below.to(x.device)
        return torch.cat([pad_top, x, pad_bot], 0)

    def roll1(self, x):
        """The roll by one of the slabs' flat buffers laid end to end
        (``torch.roll(x, 1, 0)`` of the whole): this slab's last row goes
        to the next rank's front, the last rank's to the first's."""
        if self.n == 1:
            return torch.roll(x, 1, 0)
        last = self._out(x[-1:].contiguous())
        prev = torch.empty_like(last)
        self._p2p([(last, (self.rank + 1) % self.n, dist.isend),
                   (prev, (self.rank - 1) % self.n, dist.irecv)])
        return torch.cat([prev.to(x.device), x[:-1]], 0)

    def gather_rows(self, x):
        """(rows, W[, C]) slab → the full (height, W[, C]) image on every
        rank."""
        return self.all_gather(x).reshape((self.height,) + tuple(x.shape[1:]))

    def gather_flat(self, x, width: int):
        """Flat (rows·W[, C]) slab buffer → the full flat (H·W[, C])
        buffer in the FULL image's flat layout (through image space, so
        that tiled layouts agree on both sides)."""
        full = self.gather_rows(layout.flat_to_image(x, width, self.rows))
        return layout.image_to_flat(full, width, self.height)


def svgf_sharded(ctx: ShardCtx, state: SVGFState, irr, moments_in, mv, normal, linear_z,
                 z_grad, albedo, params: SVGFParams = SVGFParams()):
    """SVGF on a row slab: gathered-history temporal + halo-exchange
    à-trous. Every array is the slab's; returns (new state slabs,
    filtered beauty rgb slab). The arithmetic is post.svgf's, in its
    order."""
    lum = color_ops.yuv_luminance(irr)
    mom = torch.stack([lum, moments_in], dim=-1)
    # the five history images share one gather and one bilinear lookup
    packed = torch.cat([state.irr, state.moments, state.history_len[..., None], state.normal,
                        state.linear_z[..., None]], dim=-1)
    prev, valid_b = reproject(ctx.gather_rows(packed), mv, y0=ctx.y0, rows=ctx.rows)
    prev_irr, prev_mom, prev_hist = prev[..., 0:3], prev[..., 3:5], prev[..., 5]
    prev_n, prev_z = prev[..., 6:9], prev[..., 9]

    n_ok = (prev_n * normal).sum(-1) > params.normal_reject_cos
    z_scale = z_grad.abs().sum(-1) + 1e-2
    z_ok = (prev_z - linear_z).abs() / (
        z_scale + linear_z.abs() * 1e-2 + 1e-4
    ) < params.depth_reject * 10.0
    valid = valid_b & n_ok & z_ok

    hist = torch.where(valid, prev_hist + 1.0, 1.0)
    a_i = torch.clamp_min(1.0 / hist, params.alpha_irr)[..., None]
    a_m = torch.clamp_min(1.0 / hist, params.alpha_moments)[..., None]
    int_irr = torch.where(valid[..., None], prev_irr + (irr - prev_irr) * a_i, irr)
    int_mom = torch.where(valid[..., None], prev_mom + (mom - prev_mom) * a_m, mom)

    var_t = torch.clamp_min(int_mom[..., 1] - torch.square(int_mom[..., 0]), 0.0)
    # 3×3 spatial variance fallback over a 1-row halo of the luminance
    lum_p = ctx.halo_pad(lum, 1)
    l1 = torch.zeros_like(lum_p)
    l2 = torch.zeros_like(lum_p)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift(lum_p, dy, dx)
            l1 = l1 + s
            l2 = l2 + s * s
    var_s = torch.clamp_min(l2 / 9.0 - torch.square(l1 / 9.0), 0.0)[1:-1]
    variance = torch.where(hist < 4.0, torch.maximum(var_t, var_s), var_t)
    new_state = SVGFState(
        irr=int_irr, moments=int_mom, history_len=hist, normal=normal, linear_z=linear_z,
    )

    # à-trous iterations with a halo exchange a step; a step whose 2·step
    # halo is taller than the slab runs on the gathered image and keeps
    # the slab's rows (only short slabs reach it)
    r_max = min(2 * (1 << max(params.iterations - 1, 0)), ctx.rows)
    aux_n = ctx.halo_pad(normal, r_max)
    aux_z = ctx.halo_pad(linear_z, r_max)
    aux_g = ctx.halo_pad(z_grad, r_max)
    full = None
    out_irr, out_var = int_irr, variance
    y0, rows = ctx.y0, ctx.rows
    for i in range(params.iterations):
        step = 1 << i
        r = 2 * step
        if r <= rows:
            sl = slice(r_max - r, r_max + rows + r)
            irr_p, var_p = atrous_iteration(
                ctx.halo_pad(out_irr, r), ctx.halo_pad(out_var, r),
                aux_n[sl], aux_z[sl], aux_g[sl], step, params,
            )
            out_irr, out_var = irr_p[r:-r], var_p[r:-r]
        else:
            if full is None:
                full = [ctx.gather_rows(x) for x in (normal, linear_z, z_grad)]
            irr_f, var_f = atrous_iteration(
                ctx.gather_rows(out_irr), ctx.gather_rows(out_var), *full, step, params
            )
            out_irr, out_var = irr_f[y0 : y0 + rows], var_f[y0 : y0 + rows]
    return new_state, out_irr * torch.clamp_min(albedo, 0.0)


def taa_sharded(ctx: ShardCtx, prev_out, cur, mv, blend_alpha=0.1):
    """TAA on a row slab: gathered-history reprojection + a 1-row halo
    for the neighbourhood clamp."""
    hist, valid = reproject(ctx.gather_rows(prev_out), mv, fallback=cur, y0=ctx.y0,
                            rows=ctx.rows)
    cur_p = ctx.halo_pad(cur, 1)
    lo = cur_p
    hi = cur_p
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift(cur_p, dy, dx)
            lo = torch.minimum(lo, s)
            hi = torch.maximum(hi, s)
    hist = torch.minimum(torch.maximum(hist, lo[1:-1]), hi[1:-1])
    out = hist + (cur - hist) * blend_alpha
    return torch.where(valid[..., None], out, cur)


def fxaa_sharded(ctx: ShardCtx, rgb, **kw):
    """FXAA on a row slab: a 1-row halo, then the single-device op."""
    return fxaa_mod.fxaa(ctx.halo_pad(rgb, 1), **kw)[1:-1]
