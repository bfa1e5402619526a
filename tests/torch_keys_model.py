"""torch model of csrc/woop_keys.cu: K4 (target keys), K5 (block union
entries) and the fused visit list, step for step as the kernels take them,
imported by tests/test_torch_keys.py. K4's warps of 32 rays move
together, as its warp-uniform branches move them:

- each box's planes ordered per axis (min, max), and per ray the near and
  far plane chosen once from the sign of its safe inverse direction;
- K4: nodes of kKeyNode consecutive boxes, each the min/max of its
  members' ordered planes with NaN planes left out (fminf/fmaxf), skipped
  by the whole warp when the node's entry is >= every lane's third, the
  insertion taken by a warp only when some lane's entry beats its third,
  a warp of dead limits writing sentinels at once; counts as the kernel's
  counts=;
- K5: a block's live rays taken by octant, each box's planes chosen once
  an octant, the least reached entry a box (dead rays contribute nothing);
- the visit list: a bitonic network over the u64 keys bits(te) << 32 | id.

``mutant`` names a deliberate fault for the tests to catch.
"""
import os
import re

import torch

from merian_quake_tpu_torch.accel import woop

WARP = 32
with open(os.path.join(os.path.dirname(woop.__file__), "..", "csrc", "woop_keys.cu")) as _f:
    KEY_NODE, MAX_LIST_BOXES = (int(re.search(rf"constexpr int {_k} = (\d+);", _src).group(1))
                                for _src in [_f.read()] for _k in ("kKeyNode", "kMaxListBoxes"))
SENTINEL = (0xFF << 22) | (0xFF << 14) | (0xFF << 6)
PAD_KEY = (1 << 63) - 1  # stands for the kernel's ~0ull: above every key


def ordered(lo, hi):
    """(a, b) f32[m, 3]: each axis's planes ordered, NaN propagating."""
    return torch.minimum(lo, hi), torch.maximum(lo, hi)


def ray_args(rays):
    """Origins, safe inverse directions (n, 3) and t_max (n,) of packed rays."""
    o, inv = woop._ray_slab_args(rays, 0, rays.shape[1])
    return o[:, 0], inv[:, 0], rays[7]


def node_planes(lo, hi, nodes):
    """K4's node boxes (a, b) f32[nn, 3]: the min/max of each node's
    members' ordered planes, a NaN plane left out as fminf/fmaxf leave it
    (NaN only where every member's plane is NaN); a partial last node
    holds the members there are."""
    a, b = ordered(lo, hi)
    na, nb = [], []
    for c0 in range(0, lo.shape[0], nodes):
        qa, qb = a[c0], b[c0]
        for c in range(c0, min(c0 + nodes, lo.shape[0])):
            qa, qb = torch.fmin(qa, a[c]), torch.fmax(qb, b[c])
        na.append(qa)
        nb.append(qb)
    return torch.stack(na), torch.stack(nb)


def entries(o, inv, lim, lo, hi, mutant=None):
    """(reach, tn) (n, m): the slab with each ray's planes chosen once, 6
    subtracts, 6 multiplies and 6 min/max; ``mutant`` "unordered" takes lo
    as the near plane of a forward axis whatever the box's order."""
    a, b = (lo, hi) if mutant == "unordered" else ordered(lo, hi)
    pos = (inv >= 0.0)[:, None, :]
    near = torch.where(pos, a[None], b[None])
    far = torch.where(pos, b[None], a[None])
    tn_k = (near - o[:, None]) * inv[:, None]
    tf_k = (far - o[:, None]) * inv[:, None]
    tn = torch.zeros_like(tn_k[..., 0])
    tf = lim[:, None].expand_as(tn)
    for k in range(3):
        tn = torch.maximum(tn, tn_k[..., k])
        tf = torch.minimum(tf, tf_k[..., k])
    return tn <= tf, tn


def _warps(x):
    return x.reshape(-1, WARP, *x.shape[1:])


def _warp_any(x):
    """(n,) bool → per lane, does any lane of its warp hold it."""
    return _warps(x).any(1, keepdim=True).expand(-1, WARP).reshape(-1)


def target_keys(rays, lo, hi, mutant=None):
    """K4's schedule → (keys i32[n], counts {slabs, node_slabs, inserts}).
    ``mutant``: "unordered" (planes not ordered), "raw_node_boxes" (node
    boxes of the raw bounds, woop.node_bounds, skipped as the kernel skips
    its own: with no never-skip flag for nodes holding an empty member),
    "skip_le" (the node visited where its entry is <= a lane's third),
    "insert_le" (a <= insertion)."""
    o, inv, lim = ray_args(rays)
    n, nc = lim.shape[0], lo.shape[0]
    reach, te = entries(o, inv, lim, lo, hi, mutant)
    nn = -(-nc // KEY_NODE)
    nlo, nhi = (woop.node_bounds(lo, hi, KEY_NODE) if mutant == "raw_node_boxes"
                else node_planes(lo, hi, KEY_NODE))
    n_reach, n_te = entries(o, inv, lim, nlo, nhi, mutant)
    warp_live = _warp_any(lim >= 0.0)
    t = [torch.full((n,), torch.inf) for _ in range(3)]
    c = [torch.full((n,), 0xFF, dtype=torch.int64) for _ in range(3)]
    counts = {"slabs": 0, "node_slabs": 0, "inserts": 0}
    lt = (lambda x, y: x <= y) if mutant == "insert_le" else (lambda x, y: x < y)
    live_warps = int(_warps(warp_live)[:, 0].sum())
    for node in range(nn):
        counts["node_slabs"] += WARP * live_warps
        near = n_te[:, node] <= t[2] if mutant == "skip_le" else n_te[:, node] < t[2]
        visit = warp_live & _warp_any(n_reach[:, node] & near)
        for cid in range(node * KEY_NODE, min((node + 1) * KEY_NODE, nc)):
            counts["slabs"] += WARP * int(_warps(visit)[:, 0].sum())
            x = te[:, cid]
            b3 = visit & reach[:, cid] & lt(x, t[2])
            counts["inserts"] += int(_warps(b3).any(1).sum())
            b2, b1 = b3 & lt(x, t[1]), b3 & lt(x, t[0])
            t[2] = torch.where(b3, torch.where(b2, t[1], x), t[2])
            c[2] = torch.where(b3, torch.where(b2, c[1], cid), c[2])
            t[1] = torch.where(b2, torch.where(b1, t[0], x), t[1])
            c[1] = torch.where(b2, torch.where(b1, c[0], cid), c[1])
            t[0] = torch.where(b1, x, t[0])
            c[0] = torch.where(b1, cid, c[0])
    keys = ((c[0] << 22) | (c[1] << 14) | (c[2] << 6)).to(torch.int32)
    return keys, counts


def te_union(rays, lo, hi, slack=False, mutant=None):
    """K5's schedule: f32[n / 128, m]. A block's live rays (limit >= 0)
    taken by octant (the signs of their safe inverse directions), each
    octant's slabs with the near and far planes that octant chooses for
    every box, the least reached entry a box, a zero entry made +0 at the
    end; in the walker's mode empty boxes are never listed. ``mutant``
    "unordered" chooses among lo/hi as given."""
    o, inv, t_max = ray_args(rays)
    lim = woop.list_slack(t_max) if slack else t_max
    a, b = (lo, hi) if mutant == "unordered" else ordered(lo, hi)
    neg = ~(inv >= 0.0)
    octant = neg[:, 0].long() | neg[:, 1].long() << 1 | neg[:, 2].long() << 2
    live = lim >= 0.0
    least = torch.full((rays.shape[1] // woop.RAY_BLOCK, lo.shape[0]), torch.inf)
    for q in range(8):
        taken = live & (octant == q)
        if not taken.any():
            continue
        flip = torch.tensor([(q >> k) & 1 == 1 for k in range(3)])
        near, far = torch.where(flip, b, a), torch.where(flip, a, b)
        tn = torch.zeros((o.shape[0], lo.shape[0]))
        tf = lim[:, None].expand_as(tn)
        for k in range(3):
            tn = torch.maximum(tn, (near[None, :, k] - o[:, None, k]) * inv[:, None, k])
            tf = torch.minimum(tf, (far[None, :, k] - o[:, None, k]) * inv[:, None, k])
        te = torch.where((tn <= tf) & taken[:, None], tn, torch.inf)
        least = torch.minimum(least, te.reshape(least.shape[0], woop.RAY_BLOCK, -1).amin(1))
    least = least + 0.0
    if slack:
        least[:, (lo > hi).any(-1)] = torch.inf
    return least


def bitonic(keys, ids):
    """The kernel's bitonic network on each row of ``keys`` (int64, padded
    to a power of two with PAD_KEY), ``ids`` moved with them: ascending."""
    size = keys.shape[1]
    idx = torch.arange(size)
    k = 2
    while k <= size:
        j = k >> 1
        while j > 0:
            a = idx[(idx & j) == 0]
            up = (a & k) == 0
            x, y = keys[:, a], keys[:, a + j]
            swap = (x > y) == up
            keys[:, a], keys[:, a + j] = torch.where(swap, y, x), torch.where(swap, x, y)
            xi, yi = ids[:, a], ids[:, a + j]
            ids[:, a], ids[:, a + j] = torch.where(swap, yi, xi), torch.where(swap, xi, yi)
            j >>= 1
        k <<= 1
    return keys, ids


def visit_list(rays, lo, hi, mutant=None):
    """The fused visit list: K5 at slack 1, then each block's keys
    bits(te) << 32 | id through the bitonic network → (te_s f32[nb, m],
    order i32[nb, m]). ``mutant`` "sort_no_id" sorts bits(te) << 32 alone
    (equal entries in the network's order)."""
    te = te_union(rays, lo, hi, slack=True)
    nb, m = te.shape
    size = 1 << max(m - 1, 0).bit_length()
    ids = torch.arange(m).expand(nb, m)
    keys = te.view(torch.int32).long() << 32
    if mutant != "sort_no_id":
        keys = keys | ids
    pad = torch.full((nb, size - m), PAD_KEY, dtype=torch.int64)
    keys, order = bitonic(torch.cat([keys, pad], 1), torch.cat([ids, pad], 1))
    te_s = (keys[:, :m] >> 32).to(torch.int32).view(torch.float32)
    return te_s, order[:, :m].to(torch.int32)
