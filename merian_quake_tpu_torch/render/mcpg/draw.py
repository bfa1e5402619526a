"""MCPG's guide-state draws: the K-draw reservoir loop.

Each lane draws ``mc_samples`` Markov-chain states from the two hash
grids (stratified: the first ``int(K·p)`` slots adaptive, those from
``ceil(K·p)`` on static, one slot between them that draws both cells and
picks by a Bernoulli of the fraction), gathers each from the frame's
packed draw table (``grids.pack_states_draw``), finalizes it and
reservoir-selects a winner by sum_w, starting from a fresh chain. The
surface pass runs it once a bounce segment, the volume pass once a volume
sample; they differ only in what they pass: the surface a dead mask (dead
lanes gather row 0), the previous-frame position as sample 0's lookup
position and the hemisphere test on static draws; the volume none of
these, and the negated view direction as the normal.

On CUDA tensors the loop is one launch of a hand-written kernel
(csrc/mcpg_draw.cu), bit for bit the torch path on the card. On CPU
tensors the torch path runs: :func:`draw_states_reference`, the kernel's
plain version, whose draw order and RNG consumption follow the JAX
package line for line.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple

import torch

from ...kernels import F, INT, P, check, entry, f32, f32_recip, launch
from ...ops import rng as rng_ops
from . import grids
from .config import MCPGConfig


class Draws(NamedTuple):
    """What the loop leaves for the sampling after it."""

    rng: torch.Tensor  # u32 values (int64)[n], the stream after the loop
    win: grids.StateSample  # the reservoir's winner ([n] each)
    win_buf: torch.Tensor  # int64[n]: the winner's table row, -1 for the fresh chain
    score_sum: torch.Tensor  # f32[n]: the draws' sum of sum_w
    mu: tuple  # K × f32[n, 3]: each draw's vMF lobe direction
    kappa: tuple  # K × f32[n]
    sum_w: tuple  # K × f32[n]: each draw's finalized sum_w
    N: tuple  # K × i32[n]


def slot_split(mcfg: MCPGConfig):
    """(slots before the first non-adaptive one, the first static slot,
    the mixed slot's adaptive probability): ``int(K·p)``, ``ceil(K·p)``
    and ``K·p - int(K·p)``, as the torch loop computes them."""
    # mc_samples_adaptive_prob must be a Python float: the slot split is
    # computed in Python
    assert isinstance(mcfg.mc_samples_adaptive_prob, float), (
        "mc_samples_adaptive_prob must be a static float"
    )
    ka_exact = mcfg.mc_samples * mcfg.mc_samples_adaptive_prob
    return int(ka_exact), math.ceil(ka_exact), ka_exact - int(ka_exact)


def draw_states_reference(rng_state, lookup_pos, pos, normal, cam_x, cl_time, table,
                          mcfg: MCPGConfig, dead=None, hemisphere: bool = False) -> Draws:
    """The torch path of :func:`draw_states` on any device: the plain
    version of csrc/mcpg_draw.cu."""
    K = mcfg.mc_samples
    nl = pos.shape[0]
    dev = pos.device
    n_adaptive, n_mixed_end, frac = slot_split(mcfg)
    lookup_level = grids.adaptive_target_level(lookup_pos, cam_x, mcfg)
    score_sum = torch.zeros((nl,), device=dev)
    mus, kappas, scores, draw_ns = [], [], [], []
    rng_state, win = grids.new_state(rng_state)
    win_buf = torch.full((nl,), -1, dtype=torch.int64, device=dev)
    for k in range(K):
        if k + 1 <= n_adaptive:
            mode = "adaptive"
        elif k >= n_mixed_end:
            mode = "static"
        else:
            mode = "mixed"
        if mode != "static":
            rng_state, abuf, ahash = grids.adaptive_cell(
                rng_state, lookup_pos, normal, cam_x, mcfg, target_level=lookup_level,
            )
        if mode != "adaptive":
            rng_state, sbuf, shash = grids.static_cell(rng_state, lookup_pos, mcfg)
        if mode == "adaptive":
            buf = abuf
        elif mode == "static":
            buf = sbuf
        else:
            rng_state, u_grid = rng_ops.uniform(rng_state)
            adaptive = u_grid < frac
            buf = torch.where(adaptive, abuf, sbuf)
        # dead lanes gather row 0: their results are discarded anyway
        # (everything downstream is gated on the lane's liveness)
        st = grids.gather_state_packed_draw(table, buf if dead is None else torch.where(dead, 0, buf))
        hemi = dict(pos=pos, normal=normal, hemisphere_check=True) if hemisphere else {}
        if mode == "adaptive":
            st = grids.finalize_load(st, ahash, cl_time)
        elif mode == "static":
            st = grids.finalize_load(st, shash, cl_time, **hemi)
        else:
            st = _select_state(adaptive, grids.finalize_load(st, ahash, cl_time),
                               grids.finalize_load(st, shash, cl_time, **hemi))
        score_sum = score_sum + st.sum_w
        rng_state, u_res = rng_ops.uniform(rng_state)
        take = u_res < st.sum_w / score_sum  # NaN-compare false
        win = _select_state(take, st, win)
        win_buf = torch.where(take, buf, win_buf)
        mu_i, kap_i = grids.state_vmf(st, pos, mcfg)
        mus.append(mu_i)
        kappas.append(kap_i)
        scores.append(st.sum_w)
        draw_ns.append(st.N)
    return Draws(rng=rng_state, win=win, win_buf=win_buf, score_sum=score_sum, mu=tuple(mus),
                 kappa=tuple(kappas), sum_w=tuple(scores), N=tuple(draw_ns))


def _select_state(mask, a: grids.StateSample, b: grids.StateSample):
    pick = lambda x, y: torch.where(mask[..., None] if x.dim() > mask.dim() else mask, x, y)
    return grids.StateSample(*[pick(x, y) for x, y in zip(a, b)])


# ---------------------------------------------------------------- the kernel (csrc/mcpg_draw.cu)

# the most draws a call takes: kMaxDraws of csrc/mcpg_draw.cu
MAX_DRAWS = 16

# rng, lookup, pos, normal, dead, cam_x, cl_time, table, n, K, n_adaptive,
# n_mixed_end, frac, hemisphere, tan2, min_w, inv_min_w, steps, inv_steps,
# inv_log_p, power, inv_static_w, the two grid sizes, tile_bits, prior,
# kappa_max, the 13 outputs and the stream
_DRAW_ARGS = ((P,) * 8 + (INT,) * 4 + (F, INT) + (F,) * 8
              + (ctypes.c_uint, ctypes.c_uint, INT, F, F) + (P,) * 14)


@lru_cache(maxsize=64)
def _constants(mcfg: MCPGConfig) -> tuple:
    """The configuration's scalars as the torch path rounds them on the
    card: (frac, tan2, min_w, inv_min_w, steps, inv_steps, inv_log_p, power,
    inv_static_w)."""
    frac = slot_split(mcfg)[2]
    return (f32(frac), *grids.level_scale(mcfg, "adaptive"), f32_recip(mcfg.mc_static_width))


def draw_states(rng_state, lookup_pos, pos, normal, cam_x, cl_time, table, mcfg: MCPGConfig,
                dead=None, hemisphere: bool = False) -> Draws:
    """The draw loop of ``mcfg.mc_samples`` draws over n lanes. rng_state:
    u32 values in int64[n]; lookup_pos (where the cells are drawn), pos
    (the lobes' origin and the hemisphere test's) and normal (the adaptive
    grid's normal bucket and the hemisphere test's): f32[n, 3]; every lane
    array contiguous; cam_x f32[3] and cl_time f32[] (the
    uniforms); table: the frame's i32[S, 8] ``grids.pack_states_draw``;
    dead: None or bool[n] (such lanes gather row 0); hemisphere: test
    static draws against the hemisphere of ``normal`` at ``pos``.

    On CUDA tensors this launches csrc/mcpg_draw.cu, its outputs new
    (``torch.empty``) and nothing synchronized, and counts the launch in
    ``draw_states.launches``; on CPU tensors it runs
    :func:`draw_states_reference`. Raises on another dtype, shape, device
    or layout, and on more than MAX_DRAWS draws."""
    n = pos.shape[0] if pos.dim() == 2 else -1
    dev = pos.device
    for name, x, dtype, shape in (("rng_state", rng_state, torch.int64, (n,)),
                                  ("lookup_pos", lookup_pos, torch.float32, (n, 3)),
                                  ("pos", pos, torch.float32, (n, 3)),
                                  ("normal", normal, torch.float32, (n, 3))):
        check(name, x, dtype, shape, dev)
    if dead is not None:
        check("dead", dead, torch.bool, (n,), dev)
    check("cam_x", cam_x, torch.float32, (3,), dev)
    check("cl_time", cl_time, torch.float32, (), dev, contiguous=False)
    check("table", table, torch.int32, (mcfg.mc_total_size, 8), dev)
    if table.data_ptr() % 16:
        raise ValueError("table: must be 16-byte aligned")
    if not 1 <= mcfg.mc_samples <= MAX_DRAWS:
        raise ValueError(f"mc_samples {mcfg.mc_samples}: the kernel takes 1 to {MAX_DRAWS} draws")
    if dev.type == "cpu":
        return draw_states_reference(rng_state, lookup_pos, pos, normal, cam_x, cl_time, table,
                                     mcfg, dead=dead, hemisphere=hemisphere)
    K = mcfg.mc_samples
    n_adaptive, n_mixed_end, _ = slot_split(mcfg)
    frac, *consts = _constants(mcfg)
    empty = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)
    rng_out, win_id, win_hash, win_buf = (empty(n, dtype=torch.int64) for _ in range(4))
    win_w, win_sum_w, win_w_cos, win_n = empty(n, 3), empty(n), empty(n), empty(n, dtype=torch.int32)
    score = empty(n)
    mu, kappa, sum_w, n_k = empty(K, n, 3), empty(K, n), empty(K, n), empty(K, n, dtype=torch.int32)
    if n:
        launch(entry("mcpg_draw", "mq_mcpg_draw", _DRAW_ARGS), dev,
               rng_state.data_ptr(), lookup_pos.data_ptr(), pos.data_ptr(), normal.data_ptr(),
               None if dead is None else dead.data_ptr(),
               cam_x.data_ptr(), cl_time.data_ptr(), table.data_ptr(), n, K, n_adaptive,
               n_mixed_end, frac, int(hemisphere), *consts,
               mcfg.mc_adaptive_size, mcfg.mc_static_size, mcfg.grid_tile_bits,
               f32(mcfg.dir_guide_prior), f32(mcfg.kappa_max),
               *[x.data_ptr() for x in (rng_out, win_id, win_w, win_sum_w, win_w_cos, win_n,
                                        win_hash, win_buf, score, mu, kappa, sum_w, n_k)])
        draw_states.launches += 1
    zero = torch.zeros((n, 4), device=dev)  # mv and T: zero, as the draw table gives them
    win = grids.StateSample(id=win_id, w_tgt=win_w, sum_w=win_sum_w, w_cos=win_w_cos,
                            mv=zero[:, :3], T=zero[:, 3], N=win_n, hash=win_hash)
    return Draws(rng=rng_out, win=win, win_buf=win_buf, score_sum=score, mu=tuple(mu.unbind(0)),
                 kappa=tuple(kappa.unbind(0)), sum_w=tuple(sum_w.unbind(0)),
                 N=tuple(n_k.unbind(0)))


draw_states.launches = 0
