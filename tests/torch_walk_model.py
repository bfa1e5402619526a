"""torch model of csrc/woop_walk.cuh, the walk that K1 (csrc/woop_nearest.cu),
K2 (csrc/woop_any.cu) and K3 (csrc/woop_stream.cu) share, and the hand-laid
inputs that drive its compacted visit: imported by tests/test_torch_accel.py
and tests/test_torch_map.py. One warp of 32 rays at a time, step for step as
the kernel takes them; the pair tests repeat the plain versions'
arithmetic, so the model must equal them bit for bit.
"""
import os
import re
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the tie table and the sparse-warp mask)
from merian_quake_tpu_torch.accel import woop  # noqa: E402

WARP = 32
# kCompactMax, kNode and kSub, read from the source so that the model walks
# the nodes the kernels walk and compacts the visits they compact
with open(os.path.join(os.path.dirname(woop.__file__), "..", "csrc", "woop_walk.cuh")) as _f:
    COMPACT_MAX, *NODE = (int(re.search(rf"constexpr int {_k} = (\d+);", _src).group(1))
                          for _src in [_f.read()] for _k in ("kCompactMax", "kNode", "kSub"))
NODE = tuple(NODE)  # (clusters a node, clusters a sub-node)
# K2's order: the walk instance csrc/woop_any.cu launches (True: K3's
# near-to-far node list, False: K1's node order)
with open(os.path.join(os.path.dirname(woop.__file__), "..", "csrc", "woop_any.cu")) as _f:
    K2_LISTED = re.search(r"launch_walk<kNode, kSub, (true|false), true>", _f.read()).group(1) == "true"
NO_KEY = (1 << 32) - 1

tie_table = chip_smoke.tie_table
sparse_warps = chip_smoke.sparse_warps


def _slack(x):
    return x + x.abs() * 1e-4 + 1e-3


def _float_key(t):
    """float_key of the kernel: order-preserving u32 image (int64 here) of
    t + 0."""
    u = (t + 0.0).view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def model_walk(rays, w, lo, hi, node, listed, anyhit=False, occluded_in=None, mutant=None):
    """The walk at ``node`` = (clusters a node, clusters a sub-node) over
    the table's packed rows and its cached boxes (woop.packed_rows,
    woop.walk_boxes), in node order (``listed`` False, K1) or along each
    warp's near-to-far node list with the horizon exit (True, K3):
    - gates in batches that share one reading of the limits; a vote a box;
    - a reached cluster is fetched at once and the tile fetched before it
      tested only then (the ring: limits lag by one tile), each lane
      gating again with its current limit;
    - a tile 1..COMPACT_MAX lanes reach is tested triangle per lane: per
      reaching ray the least float_key(t) over the 64 triangles, then the
      least index among those equal to it, committed by K1's rule; a denser
      one ray per lane.
    Any-hit: an occluded lane's limit is -inf, so once every live lane is
    occluded no gate passes and no further tile is fetched.
    Mutants: ``early_exit`` (node order: the last node a warp reaches is
    never walked; the list: the walk
    stops one node early: before the last listed node, and already where
    the entry after the next one lies beyond the horizon),
    ``stops_before_all_occluded`` (any-hit: the warp ends its walk once at
    most one live lane is still unoccluded),
    ``compact_drops_last`` (a compacted visit leaves out its last reaching
    ray), ``winner_ignores_index`` (the compacted winner among equal t is
    the highest index, not the lowest).
    Returns the nearest (t, tri) or the occlusion, like the plain versions."""
    P, S = node
    nc = lo.shape[0]
    n = rays.shape[1]
    rows = woop.packed_rows(w).reshape(nc, 3, 64, 4)
    boxes = woop.walk_boxes(lo, hi, P, S)
    nn = -(-nc // P)
    ns = -(-nc // S) if S < P else 0
    sub0, cl0 = nn, nn + ns
    assert boxes.shape == (nn + ns + nc, 8)
    out_t = torch.full((n,), woop.BIG)
    out_tri = torch.full((n,), -1, dtype=torch.int32)
    out_occ = torch.zeros(n, dtype=torch.bool) if occluded_in is None else occluded_in.clone()
    ids64 = torch.arange(64)

    for w0 in range(0, n, WARP):
        sl = slice(w0, w0 + WARP)
        o, d = rays[0:3, sl].T, rays[3:6, sl].T
        t_min, t_max = rays[6, sl], rays[7, sl]
        inv = 1.0 / torch.where(d.abs() < 1e-20, torch.where(d >= 0, 1e-20, -1e-20), d)
        best, best_tri, occ = out_t[sl], out_tri[sl], out_occ[sl]  # views: updated in place

        def limit():
            if anyhit:
                return torch.where(occ, -torch.inf, _slack(t_max))
            return _slack(torch.minimum(best, t_max))

        def done():
            """any-hit: no live lane is left unoccluded (the mutant: one)"""
            left = 1 if mutant == "stops_before_all_occluded" else 0
            return anyhit and int((limit() >= 0.0).sum()) <= left

        def reaches(ids, lim):
            """(lanes, boxes) reach and entry of boxes ``ids`` (a tensor)."""
            b = boxes[ids]
            t1 = (b[None, :, 0:3] - o[:, None]) * inv[:, None]
            t2 = (b[None, :, 4:7] - o[:, None]) * inv[:, None]
            tn = torch.clamp_min(torch.minimum(t1, t2).amax(-1), 0.0)
            tf = torch.minimum(lim[:, None], torch.maximum(t1, t2).amin(-1))
            return (tn <= tf) & (b[None, :, 3] == 0.0), tn

        def reached(first, count, end):
            """The boxes first .. first + count - 1 (below ``end``) some lane
            reaches, gated with one reading of the limits."""
            if done():
                return []
            ids = torch.arange(first, min(first + count, end))
            return ids[reaches(ids, limit())[0].any(0)].tolist()

        def commit(lane, t, tri):
            if t < best[lane] or (t == best[lane] and tri < best_tri[lane]):
                best[lane] = t
                best_tri[lane] = tri

        def test(c):
            reach = reaches(torch.tensor([cl0 + c]), limit())[0][:, 0]
            lanes = reach.nonzero()[:, 0].tolist()
            if not lanes:
                return
            a = rows[c]  # (3, 64, 4)

            def img(x, i, aff):
                p = (x[:, 0:1] * a[i, :, 0] + x[:, 1:2] * a[i, :, 1] + x[:, 2:3] * a[i, :, 2])
                return p + a[i, :, 3] if aff else p

            u0, v0, z0 = (img(o, i, True) for i in range(3))
            du, dv, dz = (img(d, i, False) for i in range(3))
            z0n = -z0
            U = u0 * dz - z0 * du
            V = v0 * dz - z0 * dv
            if anyhit:
                hit = ((U >= 0) & (V >= 0) & (dz - U - V >= 0) & (dz - 1e-12 >= 0)
                       & (z0n - t_min[:, None] * dz >= 0) & (t_max[:, None] * dz - z0n >= 0))
                if len(lanes) <= COMPACT_MAX and mutant == "compact_drops_last":
                    lanes = lanes[:-1]
                for lane in lanes:  # compacted or not: an OR over the tile
                    occ[lane] |= hit[lane].any()
                return
            front = dz > 1e-12
            ok = (front & (U >= 0) & (V >= 0) & (U + V <= dz)
                  & (z0n > t_min[:, None] * dz) & (z0n <= t_max[:, None] * dz))
            t = z0n / torch.where(front, dz, 1.0)
            if len(lanes) <= COMPACT_MAX:
                if mutant == "compact_drops_last":
                    lanes = lanes[:-1]
                for lane in lanes:
                    key = torch.where(ok[lane] & (t[lane] == t[lane]), _float_key(t[lane]), NO_KEY)
                    kmin = key.min()
                    if kmin == NO_KEY:
                        continue
                    tied = ids64[key == kmin]
                    win = int(tied.max() if mutant == "winner_ignores_index" else tied.min())
                    commit(lane, t[lane, win], c * 64 + win)
            else:
                for lane in lanes:  # ray per lane: the triangles in index order
                    for k in ids64[ok[lane]].tolist():
                        commit(lane, t[lane, k], c * 64 + k)

        state = {"pending": -1}

        def visit_members(sb):
            for b in reached(cl0 + sb * S, S, cl0 + nc):
                if done():
                    break
                c = b - cl0  # issue(c): its copy starts now
                if state["pending"] >= 0:
                    test(state["pending"])
                state["pending"] = c

        def visit_node(nd):
            if S < P:
                for b in reached(sub0 + nd * (P // S), P // S, sub0 + ns):
                    visit_members(b - sub0)
            else:
                visit_members(nd)

        if not bool((limit() >= 0.0).any()):
            continue
        if listed:
            reach, tn = reaches(torch.arange(nn), limit())
            te = torch.where(reach, tn + 0.0, torch.inf).amin(0)
            keys = sorted(((int(te[nd].view(torch.int32)) >> 13) << 14) | nd
                          for nd in range(nn) if bool(reach[:, nd].any()))
            horizon = limit().amax()
            for j, key in enumerate(keys):
                look = key
                if mutant == "early_exit":
                    if j + 1 == len(keys):
                        break
                    look = keys[j + 1]
                te_q = torch.tensor((look >> 14) << 13, dtype=torch.int32).view(torch.float32)
                if te_q > horizon:
                    break
                nd = key & ((1 << 14) - 1)
                if not done() and bool(reaches(torch.tensor([nd]), limit())[0].any()):
                    visit_node(nd)
                horizon = limit().amax()
        else:
            held = None  # early_exit: each reached node is walked only after the next one
            for g in range(0, nn, 32):
                for nd in reached(g, min(32, nn - g), nn):
                    if mutant == "early_exit":
                        nd, held = held, nd
                        if nd is None:
                            continue
                    visit_node(nd)
        if state["pending"] >= 0:
            test(state["pending"])
    if anyhit:
        return out_occ
    return out_t, out_tri
