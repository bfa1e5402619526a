"""torch model of csrc/woop_walk.cuh, the walk that K1 (csrc/woop_nearest.cu),
K2 (csrc/woop_any.cu), K3 (csrc/woop_stream.cu) and the list walker K6/K7
(csrc/woop_list.cu) share, and the hand-laid inputs that drive its
compacted visit: imported by tests/test_torch_accel.py,
tests/test_torch_map.py and tests/test_torch_schedule.py. One warp of 32
rays at a time, step for step as the kernel takes them; the pair tests
repeat the plain versions' arithmetic, so the model must equal them bit
for bit.
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
# kCompactMax, kBatch, kNode and kSub, read from the source so that the model
# walks the nodes the kernels walk, gates as many boxes on one reading of the
# limits and compacts the visits they compact
with open(os.path.join(os.path.dirname(woop.__file__), "..", "csrc", "woop_walk.cuh")) as _f:
    COMPACT_MAX, BATCH, *NODE = (
        int(re.search(rf"constexpr int {_k} = (\d+);", _src).group(1))
        for _src in [_f.read()] for _k in ("kCompactMax", "kBatch", "kNode", "kSub"))
NODE = tuple(NODE)  # (clusters a node, clusters a sub-node)
# K2's order: the walk instance csrc/woop_any.cu launches (True: K3's
# near-to-far node list, False: K1's node order)
with open(os.path.join(os.path.dirname(woop.__file__), "..", "csrc", "woop_any.cu")) as _f:
    K2_LISTED = re.search(r"launch_walk<kNode, kSub, mq::(\w+), true>",
                          _f.read()).group(1) == "kNodeList"
# the list walker's sub-node size above 32 clusters a node and the rays of a
# block a lane stands for in its compaction limit (csrc/woop_list.cu)
with open(os.path.join(os.path.dirname(woop.__file__), "..", "csrc", "woop_list.cu")) as _f:
    LIST_SUB, COMPACT_SHARE = (int(re.search(rf"constexpr int {_k} = (\d+);", _src).group(1))
                               for _src in [_f.read()] for _k in ("kListSub", "kCompactShare"))
NO_KEY = (1 << 32) - 1


def list_sub(nodes):
    """mq_woop_list_sub: clusters a sub-node at nodes of ``nodes``."""
    return nodes if nodes <= 32 else LIST_SUB


def compact_lanes(compact):
    """mq_woop_list_compact_lanes: a warp's compaction limit for the
    schedule's ``compact`` (reaching rays of a 128-ray block)."""
    return 0 if compact <= 0 else min(32, -(-compact // COMPACT_SHARE))

tie_table = chip_smoke.tie_table
sparse_warps = chip_smoke.sparse_warps


def _slack(x):
    return x + x.abs() * 1e-4 + 1e-3


def _float_key(t):
    """float_key of the kernel: order-preserving u32 image (int64 here) of
    t + 0."""
    u = (t + 0.0).view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def model_walk(rays, w, lo, hi, node, listed, anyhit=False, occluded_in=None, mutant=None,
               block_list=None, compact=COMPACT_MAX, raw_bounds=None):
    """The walk at ``node`` = (clusters a node, clusters a sub-node) over
    the table's packed rows and its cached boxes (woop.packed_rows,
    woop.walk_boxes), in node order (``listed`` False, K1), along each
    warp's near-to-far node list with the horizon exit (True, K3), or
    along each 128-ray block's list ``block_list`` = (te_s, order) (the
    list walker: K5's list, woop.visit_list; ``listed`` is then unused):
    - gates in batches that share one reading of the limits; a vote a box;
      the list walker's gates are K5's slab (woop._slab_entry) at
      woop.list_slack of the limits, K1-K3's the same slab at their slack;
    - the list walker takes its block's entries BATCH at a time, after
      reading the warp's horizon (the largest float_key of the lanes'
      limits) and keeping the entries within it; a reached entry is a
      cluster (P = 1, fetched at once) or a node (its members, or its
      sub-nodes and theirs, gated next);
    - a reached cluster is fetched at once and the tile fetched before it
      tested only then (the ring: limits lag by one tile), each lane
      gating again with its current limit;
    - a tile 1..``compact`` lanes reach (COMPACT_MAX for K1-K3, the list
      walker's compact_lanes) is tested triangle per lane: per reaching ray
      the least float_key(t) over the 64 triangles, then the least index
      among those equal to it, committed by K1's rule; a denser one ray per
      lane.
    Any-hit: an occluded lane's limit is -inf, so once every live lane is
    occluded no gate passes and no further tile is fetched.
    Mutants: ``early_exit`` (node order: the last node a warp reaches is
    never walked; the node list: the walk stops one node early: before
    the last listed node, and already where the entry after the next one
    lies beyond the horizon; the block list: an entry is kept only when the
    entry after it lies within the horizon),
    ``horizon_next_entry`` (block list: the horizon is the limit of the
    lane that holds the next entry, not the largest over the lanes),
    ``node_no_slack`` (block list: a listed node is gated with min(best,
    t_max) itself), ``unpadded_node_boxes`` (block list: the node boxes
    are node_bounds of ``raw_bounds``, the cluster bounds without the
    padding, which differ from the boxes K5 listed),
    ``stops_before_all_occluded`` (any-hit: the warp ends its walk once at
    most one live lane is still unoccluded), ``anyhit_first_occluded``
    (any-hit: it ends its walk once any live lane is occluded),
    ``compact_drops_last`` (a compacted visit leaves out its last reaching
    ray), ``compact_wrong_lanes`` (a compacted visit tests the warp's first
    k lanes, not the k that reach the tile), ``winner_ignores_index`` (the
    compacted winner among equal t is the highest index, not the lowest).
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
    if mutant == "unpadded_node_boxes":
        raw = woop.node_bounds(*raw_bounds, P)
        boxes = boxes.clone()
        boxes[:nn, 0:3], boxes[:nn, 4:7] = raw
        boxes[:nn, 3] = (raw[0] > raw[1]).any(-1).to(boxes.dtype)
    blocked = block_list is not None
    out_t = torch.full((n,), woop.BIG)
    out_tri = torch.full((n,), -1, dtype=torch.int32)
    out_occ = torch.zeros(n, dtype=torch.bool) if occluded_in is None else occluded_in.clone()
    ids64 = torch.arange(64)
    lanes32 = torch.arange(WARP)

    for w0 in range(0, n, WARP):
        sl = slice(w0, w0 + WARP)
        o, d = rays[0:3, sl].T, rays[3:6, sl].T
        t_min, t_max = rays[6, sl], rays[7, sl]
        inv = 1.0 / torch.where(d.abs() < 1e-20, torch.where(d >= 0, 1e-20, -1e-20), d)
        best, best_tri, occ = out_t[sl], out_tri[sl], out_occ[sl]  # views: updated in place
        slack = woop.list_slack if blocked else _slack

        def limit(raw=False):
            if anyhit:
                return torch.where(occ, -torch.inf, t_max if raw else slack(t_max))
            lim = torch.minimum(best, t_max)
            return lim if raw else slack(lim)

        def done():
            """any-hit: no live lane is left unoccluded (the mutants: one
            left, or any lane occluded)"""
            if not anyhit:
                return False
            if mutant == "anyhit_first_occluded":
                return bool((occ & (t_max >= 0.0)).any()) or not bool((limit() >= 0.0).any())
            left = 1 if mutant == "stops_before_all_occluded" else 0
            return int((limit() >= 0.0).sum()) <= left

        def reaches(ids, lim):
            """(lanes, boxes) reach and entry (+inf where not reached) of
            boxes ``ids`` (a tensor)."""
            b = boxes[ids]
            reach, te = woop._slab_entry(o[:, None], inv[:, None], lim[:, None], b[:, 0:3],
                                         b[:, 4:7])
            reach = reach & (b[None, :, 3] == 0.0)
            return reach, torch.where(reach, te, torch.inf)

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
            compacted = len(lanes) <= compact
            if compacted and mutant == "compact_drops_last":
                lanes = lanes[:-1]
            if compacted and mutant == "compact_wrong_lanes":
                lanes = list(range(len(lanes)))
            if anyhit:
                hit = ((U >= 0) & (V >= 0) & (dz - U - V >= 0) & (dz - 1e-12 >= 0)
                       & (z0n - t_min[:, None] * dz >= 0) & (t_max[:, None] * dz - z0n >= 0))
                for lane in lanes:  # compacted or not: an OR over the tile
                    occ[lane] |= hit[lane].any()
                return
            front = dz > 1e-12
            ok = (front & (U >= 0) & (V >= 0) & (U + V <= dz)
                  & (z0n > t_min[:, None] * dz) & (z0n <= t_max[:, None] * dz))
            t = z0n / torch.where(front, dz, 1.0)
            if compacted:
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

        def fetch(c):
            """issue(c): its copy starts now; the tile before it is tested.
            False (nothing fetched) once the walk is done (any-hit)."""
            if done():
                return False
            if state["pending"] >= 0:
                test(state["pending"])
            state["pending"] = c
            return True

        def visit_members(sb):
            for b in reached(cl0 + sb * S, S, cl0 + nc):
                if not fetch(b - cl0):
                    break

        def visit_node(nd):
            if S < P:
                for b in reached(sub0 + nd * (P // S), P // S, sub0 + ns):
                    visit_members(b - sub0)
            else:
                visit_members(nd)

        if not bool((limit() >= 0.0).any()):
            continue
        if blocked:
            blk = w0 // woop.RAY_BLOCK
            keys, ids = _float_key(block_list[0][blk]), block_list[1][blk].long()
            for j0 in range(0, len(ids), WARP):
                ck, cid = keys[j0:j0 + WARP], ids[j0:j0 + WARP]
                kept, q0 = WARP, 0
                while True:
                    lim = limit()
                    if mutant == "horizon_next_entry":
                        horizon = _float_key(lim[(q0 + 1) % WARP])
                    else:
                        horizon = _float_key(lim).max()
                    within = ck <= horizon
                    if mutant == "early_exit":
                        within = within & torch.cat([within[1:], within.new_zeros(1)])
                    kept = min(kept, int(within.sum()))  # a prefix: the list ascends
                    if q0 >= kept:
                        break
                    batch = cid[q0:min(q0 + BATCH, kept)]
                    if done():
                        hit = torch.zeros(len(batch), dtype=torch.bool)
                    else:
                        gate_lim = limit(raw=True) if mutant == "node_no_slack" and P > 1 else lim
                        hit = reaches(batch, gate_lim)[0].any(0)
                    for b in batch[hit].tolist():
                        if P > 1:
                            visit_node(b)
                        elif not fetch(b):
                            break
                    q0 += BATCH
                if kept < WARP:
                    break
        elif listed:
            reach, te = reaches(torch.arange(nn), limit())
            te = te.amin(0)
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
