"""Woop unit-triangle intersection: host precompute + the Woop kernels.

Port of merian_quake_tpu/accel/woop.py for the nearest-hit and any-hit
(visibility) paths. Each triangle stores the affine map
M = [e1 e2 n]^-1, b = -M·v0 that takes world points to (u, v,
signed-dist) space (Woop et al., JCGT 2013, the affine variant); the hit
test on the transformed origin/direction is division-free.

- ``build_woop`` / ``bake_candidacy``: host tables (numpy).
- ``woop_nearest``: the wrapper of K1, ``csrc/woop_nearest.cu`` — the
  hand-written Hopper kernel that replaces the TPU kernel
  ``_kernel_resident`` + ``_intersect_tile``. A CUDA tensor launches the
  kernel; a CPU tensor runs the plain version. K1, K2, K3 and the list
  walker are four instances of one walk (``csrc/woop_walk.cuh``: a warp of
  rays walks nodes, sub-nodes and clusters alone and fetches tiles by bulk
  copies);
  they read the table's packed rows (``pack_table``, made once where
  ``build_accel`` places a table) and boxes computed once a table
  (``walk_boxes``).
- ``intersect_woop_reference``: the plain PyTorch version (a dense
  sweep over every triangle, same epilogue and tie rule).
- ``intersect_woop``: the HitRecord-level entry point: optional coherence
  sort of bounce rays, packing, the sweep (K1, K3 or the walker),
  un-sort, exact t/u/v recompute.
- ``woop_any``: the wrapper of K2, ``csrc/woop_any.cu`` — the same TPU
  kernel with its any-hit epilogue (occlusion only), the walk's any-hit
  instance in K1's node order, with ``intersect_woop_any_reference`` as
  its plain version and ``intersect_woop_any`` (the shadow table) as its
  entry point.
- ``woop_stream``: the wrapper of K3, ``csrc/woop_stream.cu`` — the
  hand-written Hopper kernel that replaces the TPU's streamed-table
  kernel ``_kernel_stream``: the nearest-hit or any-hit result of K1/K2
  for tables of any size, each warp of rays walking its own near-to-far
  node list with an exact horizon exit. Its plain versions are
  ``intersect_woop_reference`` and ``intersect_woop_any_reference``.
- The trace schedules (:class:`TraceSchedule`, the JAX package's
  ``MQ_TARGET_KEY``, ``MQ_NODE_CLUSTERS`` and ``MQ_WOOP_COMPACT``
  switches): ``target_keys``, the wrapper of K4 (``csrc/woop_keys.cu``,
  replacing ``_kernel_target_keys``), sorts bounce rays by the ids of
  their three nearest clusters; ``te_union``, the wrapper of K5 (the same
  source, replacing ``_kernel_te_union``), gives each ray block's exact
  near-to-far visit list; ``woop_list``, the wrapper of the list walker
  (``csrc/woop_list.cu``, the walk's block-list instance: each warp walks
  its block's list with a horizon of its own), walks it over clusters
  (K1's result), over nodes of P clusters (K6, replacing
  ``_kernel_resident_nodes``) and with compacted visits (K7, replacing
  ``_intersect_tile_compact``). Their
  plain versions are ``target_keys_reference``, ``te_union_reference``
  and, for the walker, ``intersect_woop_reference`` /
  ``intersect_woop_any_reference``: a schedule changes which tiles a
  block visits, never the hit.

Routing by table size is the JAX package's default: a table of more
than ``RESIDENT_MAX_TRIS`` triangles goes to K3, a smaller one to K1 or
K2 (:func:`streamed`), or to the walker as the schedule says; the JAX
package's ``resident=`` override is not carried over. The JAX package
chains resident sweeps over parts of a large table (``_sweep_parts``)
because a TPU core's VMEM holds 65,536 triangles; K3 gives the same
result in one launch, so that is not carried over, nor are the TPU's
other schedule knobs (visit groups, sub-gates, fine tables, the
conservative bundle cull ``_cull_t_enter``, whose list K5's exact one is
a subset of): they change which tiles a TPU block visits, never the hit.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..models import atlas as atlas_mod
from ..models import materials
from ..models.types import CLUSTER_SIZE
from ..ops.linalg import as_f32

BIG = 3e38
# rays per CUDA thread block
RAY_BLOCK = 128
# tables above this many triangles go to K3 (the JAX package's VMEM
# budget, woop.py:54 there; not a crossover measured on a GPU)
RESIDENT_MAX_TRIS = 65536
# K3's largest cluster count: its visit-list key holds a 14-bit id
MAX_STREAM_CLUSTERS = 1 << 14
# K4's largest cluster count: its key holds three 8-bit ids (the JAX
# package's rule, woop.py:1653 there)
MAX_KEY_CLUSTERS = 256
# the fused visit list's largest box count (csrc/woop_keys.cu kMaxListBoxes):
# the walker runs on tables of up to RESIDENT_MAX_TRIS triangles, 1,024
# clusters of CLUSTER_SIZE
MAX_LIST_BOXES = 1024


class TraceSchedule(NamedTuple):
    """How the sweeps over a table of up to RESIDENT_MAX_TRIS triangles
    visit its clusters: the JAX package's ``MQ_TARGET_KEY``,
    ``MQ_NODE_CLUSTERS`` and ``MQ_WOOP_COMPACT`` switches (woop.py:1584-1597,
    :1649-1655 there), taken as an argument. None of them changes a hit.

    - ``target_key``: sorted (bounce) rays are sorted by K4's key (the ids
      of each ray's three nearest clusters) when the table has at most
      MAX_KEY_CLUSTERS clusters, and walk K5's list (P = 1).
    - ``node_clusters`` = P > 1 (dividing 128): nearest-hit and any-hit
      sweeps walk a list of nodes of P consecutive clusters (K6) when the
      table has more than P clusters.
    - ``compact`` > 0: nearest-hit walks test a tile that few rays reach
      on those rays alone (K7). The JAX package counts the reaching rays
      of a 128-ray block; the walker's warps have 32 lanes, so a warp
      compacts a visit that 1..ceil(compact / 4) of its lanes reach (at
      most 32: the same share of the rays; :func:`compact_lanes`).
      ``compact`` = 0 compacts no visit.
    A table routed to K3 ignores the schedule, as in the JAX package.
    """

    target_key: bool = False
    node_clusters: int = 0
    compact: int = 0


def build_woop(
    v0, v1, v2, candidate, chunk: int = CLUSTER_SIZE
) -> tuple[np.ndarray, np.ndarray]:
    """Host precompute: (w[3T, 8] packed rows, updated candidate).

    Layout (3T, 8): per CLUSTER_SIZE chunk, the chunk's row-0 vectors,
    then row-1, then row-2 (each [A | b] in columns 0-3). Front-facing
    by the reference's convention (n_ref = cross(v2-v0, v1-v0), hit iff
    d·n_ref < 0) ⇔ dz > 0. Non-candidate triangles get all-zero rows
    (dz ≡ 0 → never front-facing), so candidacy is baked in.
    """
    v0 = np.asarray(v0, np.float64)
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    m = np.stack([e1, e2, n], axis=-1)  # columns e1 e2 n
    det = np.linalg.det(m)
    ok = np.abs(det) > 1e-12
    cand = np.asarray(candidate, bool) & ok
    m_safe = np.where(ok[:, None, None], m, np.eye(3)[None])
    inv = np.linalg.inv(m_safe)  # (T, 3, 3) rows of M
    b = -np.einsum("tij,tj->ti", inv, v0)
    t = v0.shape[0]
    c = chunk
    if t % c:
        raise ValueError(f"triangle count {t} is not a multiple of {c}")
    rows = np.concatenate([inv, b[:, :, None]], axis=2).astype(np.float32)
    rows = np.where(cand[:, None, None], rows, 0.0)
    blocks = rows.reshape(t // c, c, 3, 4).transpose(0, 2, 1, 3)
    w = np.zeros((3 * t, 8), np.float32)
    w[:, :4] = blocks.reshape(3 * t, 4)
    return w, cand


def bake_candidacy(w: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """Zero the w rows of non-candidate triangles (layout-aware); the
    any-hit tables of K2 are built this way from ``woop_w``."""
    t = cand.shape[0]
    c = CLUSTER_SIZE
    mask = np.broadcast_to(
        np.asarray(cand, bool).reshape(t // c, 1, c), (t // c, 3, c)
    ).reshape(3 * t)
    return np.where(mask[:, None], w, 0.0).astype(np.float32)


def pack_table(w: torch.Tensor) -> torch.Tensor:
    """Attach to the table ``w`` f32[3T, 8] its packed rows ``w.rows4``
    f32[3T, 4] (columns 0-3; columns 4-7 are zero by contract), made once
    where the table is placed on its device: a cluster's tile is then 3,072
    contiguous bytes, which K1, K2 and K3 fetch with one bulk copy. Returns
    ``w``. A copy or a view of ``w`` does not carry it."""
    w.rows4 = w[:, :4].contiguous()
    return w


def packed_rows(w: torch.Tensor) -> torch.Tensor:
    """The packed rows :func:`pack_table` attached to ``w``; raises on a
    table without them (nothing packs per call)."""
    rows4 = getattr(w, "rows4", None)
    if rows4 is None:
        raise ValueError("this Woop table has no packed rows: build it with build_accel, or "
                         "call woop.pack_table(w) once where it is placed on the device")
    _check("w.rows4", rows4, torch.float32, (w.shape[0], 4), w.device)
    return rows4


def _cached(owner, key, partner, make):
    """``make()``, computed once and kept on the tensor ``owner`` under
    ``key`` for as long as ``partner`` is the same tensor (a tensor or a
    tuple of tensors; :func:`rewrite_cached` makes it anew in place)."""
    cache = owner.__dict__.setdefault("_mq_cache", {})
    hit = cache.get(key)
    if hit is None or hit[0] is not partner:
        hit = cache[key] = (partner, make(), make)
    return hit[1]


def _tensors(value):
    return value if isinstance(value, tuple) else (value,)


def rewrite_cached(owner):
    """Make anew, in place, what :func:`_cached` keeps on ``owner`` after
    ``owner`` (or the partner of an entry) was written in place: each
    entry is computed again and copied into the tensors it already holds,
    then what those tensors keep in turn. Every derived table keeps its
    storage, so a captured frame (renderer.compile_frame), which holds
    their addresses, reads this refresh's values. Only device work: no
    value is read to the host."""
    for _, value, make in owner.__dict__.get("_mq_cache", {}).values():
        held = _tensors(value)
        for dst, src in zip(held, _tensors(make())):
            dst.copy_(src)
        for dst in held:
            rewrite_cached(dst)


def padded_bounds(lo, hi):
    """:func:`_pad_bounds` of a table's cluster AABBs, contiguous, computed
    once a table (kept on ``lo``), so that every trace hands the kernels
    the same two tensors and what is derived from them is cached too."""
    return _cached(lo, "padded", hi,
                   lambda: tuple(x.contiguous() for x in _pad_bounds(lo, hi)))


def walk_boxes(lo, hi, nodes: int, sub: int) -> torch.Tensor:
    """The boxes the walks read (K1, K2, K3, the list walker), f32[nn +
    ns + nc, 8]: the boxes of nodes of ``nodes`` consecutive clusters (nn
    = ceil(nc / nodes);
    :func:`node_bounds` of the padded cluster bounds lo/hi f32[nc, 3]),
    then, when ``sub`` < ``nodes``, of sub-nodes of ``sub`` clusters (ns =
    ceil(nc / sub), else 0), then the cluster boxes, each (lo.xyz, empty
    flag, hi.xyz, 0); the flag is 1 for an empty box (lo > hi on some
    axis: no gate may pass it), else 0. Ray-independent, so computed once
    a table and kept on ``lo``."""
    def make():
        levels = [node_bounds(lo, hi, nodes)] + ([node_bounds(lo, hi, sub)] if sub < nodes else [])
        blo = torch.cat([x[0] for x in levels] + [lo])
        bhi = torch.cat([x[1] for x in levels] + [hi])
        empty = (blo > bhi).any(-1, keepdim=True).to(lo.dtype)
        return torch.cat([blo, empty, bhi, torch.zeros_like(empty)], dim=1).contiguous()

    return _cached(lo, ("boxes", nodes, sub), hi, make)


def _sort_keys(accel, o, d):
    """Bounce-ray binning key (u32 value in int64): direction octant +
    dominant-axis pair in the high bits, then the origin Morton code."""
    lo = accel.world_lo
    ext = torch.clamp_min(accel.world_hi - lo, 1e-3)
    q = torch.clamp((o - lo) / ext * 255.0, 0.0, 255.0).to(torch.int64)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    octant = (
        (d[:, 0] >= 0).long()
        | ((d[:, 1] >= 0).long() << 1)
        | ((d[:, 2] >= 0).long() << 2)
    )
    ad = d.abs()
    fine = (ad[:, 0] > ad[:, 2]).long() | ((ad[:, 1] > ad[:, 2]).long() << 1)
    return (octant << 26) | (fine << 24) | (morton & 0xFFFFFF)


def _dot(a, b):
    """Row-wise dot product of (N, 3) tensors, ((a0·b0 + a1·b1) + a2·b2)
    with each step rounded: the alpha walk's order (csrc/woop_common.cuh
    ``dot3``), where a reduction's order would be the library's."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross(a, b):
    """Row-wise cross product of (N, 3) tensors, each term rounded on its
    own (csrc/woop_common.cuh ``cross_term``)."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)


def _recompute_tuv(tri_attr, o, d, t_approx, tri):
    """Exact (t, u, v) at the committed hit, from the winning triangle's
    vertices (``tri_attr`` columns 0-8) — O(rays) instead of tracking u/v
    through the sweep. The alpha walk computes the same bit for bit."""
    vattr = tri_attr[torch.clamp_min(tri, 0).long(), 0:9]
    v0, v1, v2 = vattr[:, 0:3], vattr[:, 3:6], vattr[:, 6:9]
    e1 = v1 - v0
    e2 = v2 - v0
    nrm = _cross(e1, e2)
    dn = _dot(d, nrm)
    t = _dot(v0 - o, nrm) / torch.where(dn.abs() > 1e-20, dn, 1.0)
    p = o + t[:, None] * d
    q = p - v0
    d00 = _dot(e1, e1)
    d01 = _dot(e1, e2)
    d11 = _dot(e2, e2)
    d20 = _dot(q, e1)
    d21 = _dot(q, e2)
    denom = d00 * d11 - d01 * d01
    inv = 1.0 / torch.where(denom.abs() > 1e-18, denom, 1.0)
    u = (d11 * d20 - d01 * d21) * inv
    v = (d00 * d21 - d01 * d20) * inv
    hit = tri >= 0
    return (
        torch.where(hit, t, t_approx),
        torch.where(hit, u, 0.0),
        torch.where(hit, v, 0.0),
    )


def _pack_rays(o, d, t_min_b, t_max_b, ray_block):
    """(8, n_padded) ray matrix; padding rays are dead (t_max = -1)."""
    n = o.shape[0]
    pad = (-n) % ray_block
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, d.new_ones((pad, 3))])
        t_min_b = torch.cat([t_min_b, t_min_b.new_zeros((pad,))])
        t_max_b = torch.cat([t_max_b, t_max_b.new_full((pad,), -1.0)])
    return torch.cat(
        [o.T, d.T, t_min_b[None], t_max_b[None]], dim=0
    ).contiguous()


def _pad_bounds(lo, hi):
    """Cluster AABBs grown by a small relative + absolute margin, so the
    kernel's per-ray gate stays conservative under rounding. Empty
    clusters (lo = +1e30 > hi = -1e30) stay empty."""
    return lo - (lo.abs() * 1e-5 + 1e-3), hi + (hi.abs() * 1e-5 + 1e-3)


def _max_pairs(t):
    """Elements of a plain version's (rays × work) temporaries per chunk."""
    return 1 << 26 if t.is_cuda else 1 << 24


def intersect_woop_reference(rays: torch.Tensor, w: torch.Tensor):
    """Plain PyTorch version of K1: dense Woop sweep over every triangle.

    rays f32[8, n], w f32[3T, 8] → (t f32[n] (BIG on a miss), tri i32[n]
    (-1 on a miss)). Same epilogue, arithmetic order and lowest-index tie
    rule as the kernel; chunked over rays so that each (rays × T)
    temporary holds 2^24 elements on the CPU, 2^26 on a card.
    """
    max_pairs = _max_pairs(rays)
    n = rays.shape[1]
    T = w.shape[0] // 3
    C = CLUSTER_SIZE
    rows = w.reshape(T // C, 3, C, 8)[..., :4].permute(1, 0, 2, 3).reshape(3, T, 4)
    tri_ids = torch.arange(T, device=w.device, dtype=torch.int32)
    out_t = torch.empty(n, dtype=torch.float32, device=rays.device)
    out_tri = torch.empty(n, dtype=torch.int32, device=rays.device)
    step = max(1, max_pairs // max(T, 1))
    for s in range(0, n, step):
        e = min(n, s + step)
        o = rays[0:3, s:e].T[:, :, None]  # (R, 3, 1)
        d = rays[3:6, s:e].T[:, :, None]
        t_min = rays[6, s:e][:, None]
        t_max = rays[7, s:e][:, None]

        def affine(a):  # a: (T, 4) → origin and direction images (R, T)
            po = o[:, 0] * a[:, 0] + o[:, 1] * a[:, 1] + o[:, 2] * a[:, 2] + a[:, 3]
            pd = d[:, 0] * a[:, 0] + d[:, 1] * a[:, 1] + d[:, 2] * a[:, 2]
            return po, pd

        u0, du = affine(rows[0])
        v0, dv = affine(rows[1])
        z0, dz = affine(rows[2])
        z0n = -z0
        U = u0 * dz - z0 * du
        V = v0 * dz - z0 * dv
        front = dz > 1e-12
        ok = (
            front
            & (U >= 0.0)
            & (V >= 0.0)
            & (U + V <= dz)
            & (z0n > t_min * dz)
            & (z0n <= t_max * dz)
        )
        t_m = torch.where(ok, z0n / torch.where(front, dz, 1.0), BIG)
        best = t_m.amin(1)
        first = torch.where(t_m == best[:, None], tri_ids, T).amin(1)
        out_t[s:e] = best
        out_tri[s:e] = torch.where(best < BIG, first, -1).to(torch.int32)
    return out_t, out_tri


def intersect_woop_any_reference(rays: torch.Tensor, w: torch.Tensor, occluded_in=None):
    """Plain PyTorch version of K2: dense any-hit sweep over every triangle.

    rays f32[8, n], w f32[3T, 8] → occluded bool[n]: some pair passes the
    any-hit epilogue of the TPU kernel (woop.py:786-807 of the JAX
    package), every term ≥ 0:
        U, V, (dz − U) − V, dz − 1e-12, z0n − t_min·dz, t_max·dz − z0n.
    A NaN term rejects its pair. ``occluded_in`` (bool[n]) is OR-ed in:
    a warm start from an earlier sweep. Arithmetic in the kernel's order;
    chunked over rays like :func:`intersect_woop_reference`.
    """
    max_pairs = _max_pairs(rays)
    n = rays.shape[1]
    T = w.shape[0] // 3
    C = CLUSTER_SIZE
    rows = w.reshape(T // C, 3, C, 8)[..., :4].permute(1, 0, 2, 3).reshape(3, T, 4)
    out = torch.empty(n, dtype=torch.bool, device=rays.device)
    step = max(1, max_pairs // max(T, 1))
    for s in range(0, n, step):
        e = min(n, s + step)
        o = rays[0:3, s:e].T[:, :, None]  # (R, 3, 1)
        d = rays[3:6, s:e].T[:, :, None]
        t_min = rays[6, s:e][:, None]
        t_max = rays[7, s:e][:, None]

        def affine(a):  # a: (T, 4) → origin and direction images (R, T)
            po = o[:, 0] * a[:, 0] + o[:, 1] * a[:, 1] + o[:, 2] * a[:, 2] + a[:, 3]
            pd = d[:, 0] * a[:, 0] + d[:, 1] * a[:, 1] + d[:, 2] * a[:, 2]
            return po, pd

        u0, du = affine(rows[0])
        v0, dv = affine(rows[1])
        z0, dz = affine(rows[2])
        z0n = -z0
        U = u0 * dz - z0 * du
        V = v0 * dz - z0 * dv
        ok = (
            (U >= 0.0)
            & (V >= 0.0)
            & (dz - U - V >= 0.0)
            & (dz - 1e-12 >= 0.0)
            & (z0n - t_min * dz >= 0.0)
            & (t_max * dz - z0n >= 0.0)
        )
        out[s:e] = ok.any(1)
    if occluded_in is not None:
        out |= occluded_in
    return out


_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _kernel_lib(name, entry, argtypes):
    """The C entry point ``entry`` (default ``mq_<name>``) of
    ``csrc/<name>.cu``, taking ``argtypes`` and returning a CUDA error."""
    from ..kernels import load_library

    fn = getattr(load_library(name), entry or f"mq_{name}")
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def _call(fn, device, *args):
    """Call a kernel's C entry point on ``device``'s current stream (the
    last argument); raise on a refused launch. The entry points launch,
    query (occupancy, a function attribute) and read the launch error:
    none synchronizes or allocates, so a CUDA graph captures them as
    they are, on the capture's stream."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {err}")


# the columns of the walk's profile (K1, K2, K3 and the list walker;
# ``counts=`` int64[n_pad / RAY_BLOCK, 10]): cycles (clock64, summed over a
# CTA's warps) in the node list, in the gates that look for the next tile
# (nodes, sub-nodes, clusters), in issuing a tile and gating it again at
# its test, in tile waits, in pair loops and in the whole kernel; the (ray,
# triangle) pairs tested; the warp-issued pairs (warp iterations of a pair
# loop: 64 a ray-per-lane visit, 2k one compacted on k rays); the tile
# visits (tests some lane reached) and the compacted ones
PROF_FIELDS = ("list", "search", "visit", "wait", "pairs_cycles", "total", "pairs",
               "warp_pairs", "visits", "compact_visits")


def ctas_per_sm(name, nc):
    """CTAs of kernel ``name`` (``woop_nearest``, ``woop_any``,
    ``woop_stream`` or ``woop_list``, the nearest-hit frame instance, or
    an alpha walk, ``woop_nearest_alpha`` or ``woop_stream_alpha``) that
    fit one SM for a table of ``nc`` clusters
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = "woop_alpha" if name.endswith("_alpha") else name
    return _kernel_lib(lib, f"mq_{name}_ctas_per_sm", (_INT,))(nc)


def node_sizes(name):
    """(clusters a node, clusters a sub-node) of kernel ``name``'s walk
    (``woop_nearest``, ``woop_any`` or ``woop_stream``): compile-time constants of
    csrc/woop_walk.cuh, read from the built library."""
    return tuple(_kernel_lib(name, f"mq_{name}_{level}", ())() for level in ("node", "sub"))


# the arguments of the walk's entry points: (rays, n_pad, rows4, boxes, nc,
# block, out0, out1, prof, stream); the any-hit ones (K2, K3's any-hit
# form) take (occ_in, out) as (out0, out1)
_WALK_ARGS = (_P, _I64, _P, _P, _INT, _INT, _P, _P, _P, _P)


def _profile(counts, n_pad, device, short=("pairs",)):
    """(prof, finish) for a walk instance's ``counts``: None (no profile),
    an int64[n_pad / RAY_BLOCK, len(PROF_FIELDS)] CUDA tensor (the whole
    profile, written in place), or one of int64[n_pad / RAY_BLOCK] (the
    pairs each CTA tested) or, for ``short`` of more fields,
    int64[n_pad / RAY_BLOCK, len(short)] (those columns). ``prof`` is the
    zeroed buffer the kernel fills; ``finish()`` copies ``short`` from it
    into ``counts``."""
    nb = n_pad // RAY_BLOCK
    if counts is None:
        return None, lambda: None
    if counts.dim() == 2 and counts.shape[1] == len(PROF_FIELDS):
        _check("counts", counts, torch.int64, (nb, len(PROF_FIELDS)), device)
        return counts.zero_(), lambda: None
    want = (nb,) if len(short) == 1 else (nb, len(short))
    _check("counts", counts, torch.int64, want, device)
    prof = torch.zeros((nb, len(PROF_FIELDS)), dtype=torch.int64, device=device)
    cols = [PROF_FIELDS.index(f) for f in short]
    return prof, lambda: counts.copy_(prof[:, cols].reshape(want))


def _aligned_rows(name, w):
    """The table's packed rows, checked for the bulk copies."""
    rows4 = packed_rows(w)
    if rows4.data_ptr() % 16:
        raise ValueError(f"{name}: the packed rows must be 16-byte aligned (bulk copies)")
    return rows4


def _launch_walk(name, rays, w, cluster_lo, cluster_hi, out0, out1, counts, entry=None):
    """Launch K1, K2 or K3 (the walk of csrc/woop_walk.cuh) on the current
    stream, with the table's packed rows and its cached boxes, packed for
    the library's :func:`node_sizes`; raise on a refused launch or a table
    without packed rows.
    ``counts`` is None (the frame path: the instance without the profile),
    an int64[n_pad / RAY_BLOCK] CUDA tensor that gets the (ray, triangle)
    pairs each CTA tested, or an int64[n_pad / RAY_BLOCK, 10] one that gets
    the whole profile (PROF_FIELDS)."""
    n_pad = rays.shape[1]
    rows4 = _aligned_rows(name, w)
    boxes = walk_boxes(cluster_lo, cluster_hi, *node_sizes(name))
    prof, finish = _profile(counts, n_pad, rays.device)
    _call(_kernel_lib(name, entry, _WALK_ARGS), rays.device, rays.data_ptr(), n_pad,
          rows4.data_ptr(), boxes.data_ptr(), cluster_lo.shape[0], RAY_BLOCK, out0, out1,
          None if prof is None else prof.data_ptr())
    finish()


def _refuse_counts_on_cpu(counts):
    if counts is not None:
        raise ValueError("counts: only a kernel on the card counts its work")


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype}{tuple(shape)}, got {x.dtype}{tuple(x.shape)}"
        )
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_rays(rays):
    """Validate packed rays f32[8, n_pad]; returns n_pad."""
    n_pad = rays.shape[1] if rays.dim() == 2 else -1
    if n_pad <= 0 or n_pad % RAY_BLOCK:
        raise ValueError(f"{n_pad} rays: must be a positive multiple of {RAY_BLOCK}")
    _check("rays", rays, torch.float32, (8, n_pad), rays.device)
    if rays.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rays.device}")
    return n_pad


def _check_k_inputs(rays, w, cluster_lo, cluster_hi):
    """Validate the arguments the Woop sweeps share; returns n_pad."""
    n_pad = _check_rays(rays)
    nc = w.shape[0] // 3 // CLUSTER_SIZE
    _check("w", w, torch.float32, (3 * nc * CLUSTER_SIZE, 8), rays.device)
    _check("cluster_lo", cluster_lo, torch.float32, (nc, 3), rays.device)
    _check("cluster_hi", cluster_hi, torch.float32, (nc, 3), rays.device)
    return n_pad


def woop_nearest(rays, w, cluster_lo, cluster_hi, counts=None):
    """K1: nearest front-facing hit per ray. Returns (t f32[n_pad],
    tri i32[n_pad]); t = BIG and tri = -1 on a miss.

    rays f32[8, n_pad] (o.xyz, d.xyz, t_min, t_max), n_pad a multiple of
    RAY_BLOCK; w f32[3T, 8], with its packed rows (:func:`pack_table`)
    when on a card; cluster_lo/hi f32[nc, 3], the padded AABBs the gates
    test (:func:`padded_bounds`; the node boxes come from them, once). On
    CUDA tensors this launches csrc/woop_nearest.cu and counts the launch
    in ``woop_nearest.launches``; on CPU tensors it runs
    :func:`intersect_woop_reference`. ``counts``: see :func:`_launch_walk`
    (None on the frame path).
    """
    n_pad = _check_k_inputs(rays, w, cluster_lo, cluster_hi)
    if rays.device.type == "cpu":
        _refuse_counts_on_cpu(counts)
        return intersect_woop_reference(rays, w)
    out_t = torch.empty(n_pad, dtype=torch.float32, device=rays.device)
    out_tri = torch.empty(n_pad, dtype=torch.int32, device=rays.device)
    _launch_walk("woop_nearest", rays, w, cluster_lo, cluster_hi,
                 out_t.data_ptr(), out_tri.data_ptr(), counts)
    woop_nearest.launches += 1
    return out_t, out_tri


woop_nearest.launches = 0


def woop_any(rays, w, cluster_lo, cluster_hi, occluded_in=None, counts=None):
    """K2: is each ray occluded? Returns bool[n_pad].

    Arguments as :func:`woop_nearest`'s (``w`` is the shadow, proxy or
    full table, with its packed rows on a card); ``occluded_in``
    (bool[n_pad] or None) marks rays already known to be occluded. On
    CUDA tensors this launches csrc/woop_any.cu (the any-hit instance of
    the walk) and counts the launch in ``woop_any.launches``; on CPU
    tensors it runs :func:`intersect_woop_any_reference`. ``counts``: see
    :func:`_launch_walk`.
    """
    n_pad = _check_k_inputs(rays, w, cluster_lo, cluster_hi)
    if occluded_in is not None:
        _check("occluded_in", occluded_in, torch.bool, (n_pad,), rays.device)
    if rays.device.type == "cpu":
        _refuse_counts_on_cpu(counts)
        return intersect_woop_any_reference(rays, w, occluded_in)
    out = torch.empty(n_pad, dtype=torch.bool, device=rays.device)
    occ_ptr = None if occluded_in is None else occluded_in.data_ptr()
    _launch_walk("woop_any", rays, w, cluster_lo, cluster_hi, occ_ptr, out.data_ptr(), counts)
    woop_any.launches += 1
    return out


woop_any.launches = 0


def woop_stream(rays, w, cluster_lo, cluster_hi, *, anyhit=False, occluded_in=None,
                counts=None):
    """K3: K1's result (``anyhit=False``: (t f32[n_pad], tri i32[n_pad]))
    or K2's (``anyhit=True``: occluded bool[n_pad], warm-started by
    ``occluded_in``) for a table of any size up to MAX_STREAM_CLUSTERS
    clusters, arguments as theirs.

    On CUDA tensors this launches csrc/woop_stream.cu (its nearest or
    any-hit entry point) and counts the launch in
    ``woop_stream.launches`` (the any-hit ones also in
    ``woop_stream.anyhit_launches``); on CPU tensors it runs
    :func:`intersect_woop_reference` or
    :func:`intersect_woop_any_reference`, which compute exactly its
    function: only the schedule differs.
    """
    nc = cluster_lo.shape[0]
    if nc > MAX_STREAM_CLUSTERS:
        raise ValueError(f"woop_stream: {nc} clusters, at most {MAX_STREAM_CLUSTERS}")
    n_pad = _check_k_inputs(rays, w, cluster_lo, cluster_hi)
    if occluded_in is not None:
        if not anyhit:
            raise ValueError("woop_stream: occluded_in needs anyhit=True")
        _check("occluded_in", occluded_in, torch.bool, (n_pad,), rays.device)
    if rays.device.type == "cpu":
        _refuse_counts_on_cpu(counts)
        if anyhit:
            return intersect_woop_any_reference(rays, w, occluded_in)
        return intersect_woop_reference(rays, w)
    if anyhit:
        out = torch.empty(n_pad, dtype=torch.bool, device=rays.device)
        occ_ptr = None if occluded_in is None else occluded_in.data_ptr()
        _launch_walk("woop_stream", rays, w, cluster_lo, cluster_hi, occ_ptr,
                     out.data_ptr(), counts, entry="mq_woop_stream_any")
        woop_stream.anyhit_launches += 1
    else:
        out_t = torch.empty(n_pad, dtype=torch.float32, device=rays.device)
        out_tri = torch.empty(n_pad, dtype=torch.int32, device=rays.device)
        _launch_walk("woop_stream", rays, w, cluster_lo, cluster_hi,
                     out_t.data_ptr(), out_tri.data_ptr(), counts)
        out = (out_t, out_tri)
    woop_stream.launches += 1
    return out


woop_stream.launches = 0
woop_stream.anyhit_launches = 0


def streamed(w) -> bool:
    """Does a sweep over table ``w`` go to K3 (more than
    RESIDENT_MAX_TRIS triangles) rather than K1/K2?"""
    return w.shape[0] // 3 > RESIDENT_MAX_TRIS


# ---------------------------------------------------------------- schedules


def list_slack(lim):
    """The walk's slack on a limit, (lim + |lim|·1e-4) + 1e-3 with each
    step rounded: csrc/woop_common.cuh's ``list_slack`` bit for bit
    (K1's ``with_slack`` uses an FMA, which PyTorch cannot repeat)."""
    return (lim + lim.abs() * 1e-4) + 1e-3


def _slab_entry(o, inv, lim, lo, hi):
    """The slab of the JAX package's ``_slab_te_lanes`` (woop.py:852-874
    there) on broadcast shapes: o, inv (..., 1, 3), lim (..., 1), lo/hi
    (M, 3) → (reach, te) (..., M); te = tn + 0 where reached, else +inf.
    min/max propagate NaN, as jnp.minimum/maximum and the kernels do."""
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tn = torch.zeros_like(t1[..., 0])
    tf = lim.expand_as(tn)
    for k in range(3):
        tn = torch.maximum(tn, torch.minimum(t1[..., k], t2[..., k]))
        tf = torch.minimum(tf, torch.maximum(t1[..., k], t2[..., k]))
    reach = tn <= tf
    return reach, torch.where(reach, tn + 0.0, torch.inf)


def _ray_slab_args(rays, s, e):
    """Origins and safe inverse directions (R, 1, 3) of rays [s, e)."""
    d = rays[3:6, s:e].T
    tiny = torch.where(d >= 0.0, 1e-20, -1e-20).to(d.dtype)
    inv = 1.0 / torch.where(d.abs() < 1e-20, tiny, d)
    return rays[0:3, s:e].T[:, None, :], inv[:, None, :]


def target_keys_reference(rays, lo, hi):
    """Plain PyTorch version of K4: i32[n] c1 << 22 | c2 << 14 | c3 << 6,
    the ids of each ray's three least slab entries (limit: its t_max,
    rays row 7) over the boxes lo/hi f32[nc, 3], 0xFF where it reaches
    fewer. A stable sort by entry keeps the lowest ids on equal entries,
    as the JAX kernel's strict ``<`` insertion over ascending ids does."""
    n = rays.shape[1]
    nc = lo.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=rays.device)
    step = max(1, _max_pairs(rays) // max(nc, 1))
    for s in range(0, n, step):
        e = min(n, s + step)
        o, inv = _ray_slab_args(rays, s, e)
        te = _slab_entry(o, inv, rays[7, s:e][:, None], lo, hi)[1]
        if nc < 3:
            te = torch.cat([te, te.new_full((e - s, 3 - nc), torch.inf)], 1)
        ts, ids = torch.sort(te, dim=1, stable=True)
        ids = torch.where(ts[:, :3] < torch.inf, ids[:, :3], 0xFF)
        out[s:e] = ((ids[:, 0] << 22) | (ids[:, 1] << 14) | (ids[:, 2] << 6)).to(torch.int32)
    return out


def _check_boxes(name, lo, hi, device):
    m = lo.shape[0] if lo.dim() == 2 else -1
    _check(f"{name}_lo", lo, torch.float32, (m, 3), device)
    _check(f"{name}_hi", hi, torch.float32, (m, 3), device)
    return m


_KEYS_ARGS = (_P, _I64, _P, _P, _INT, _P, _P, _P)
_UNION_ARGS = (_P, _I64, _P, _P, _INT, _INT, _P, _P)
_VISIT_LIST_ARGS = (_P, _I64, _P, _P, _INT, _P, _P, _P)
# K4's ``counts`` columns, per CTA: the (ray, box) slabs of member boxes and
# of node boxes it computed (32 a warp's slab) and its warps' insertions
KEY_COUNTS = ("slabs", "node_slabs", "inserts")


def target_keys(rays, lo, hi, counts=None):
    """K4: each ray's target key (see :func:`target_keys_reference`),
    i32[n_pad]. rays f32[8, n_pad] (n_pad a multiple of RAY_BLOCK); lo/hi
    f32[nc, 3], nc ≤ MAX_KEY_CLUSTERS, the accel's cluster AABBs as they
    are. On CUDA tensors this launches csrc/woop_keys.cu and counts the
    launch in ``target_keys.launches``; on CPU tensors it runs the plain
    version. ``counts``: None (the frames' instance), or an int64 CUDA
    tensor [n_pad / RAY_BLOCK, 3] that gets per CTA the work of KEY_COUNTS
    (the counting instance)."""
    n_pad = _check_rays(rays)
    nc = _check_boxes("cluster", lo, hi, rays.device)
    if nc > MAX_KEY_CLUSTERS:
        raise ValueError(f"target_keys: {nc} clusters, at most {MAX_KEY_CLUSTERS}")
    if rays.device.type == "cpu":
        _refuse_counts_on_cpu(counts)
        return target_keys_reference(rays, lo, hi)
    if counts is not None:
        _check("counts", counts, torch.int64, (n_pad // RAY_BLOCK, len(KEY_COUNTS)), rays.device)
        counts.zero_()
    out = torch.empty(n_pad, dtype=torch.int32, device=rays.device)
    _call(_kernel_lib("woop_keys", "mq_target_keys", _KEYS_ARGS), rays.device, rays.data_ptr(),
          n_pad, lo.data_ptr(), hi.data_ptr(), nc, out.data_ptr(),
          None if counts is None else counts.data_ptr())
    target_keys.launches += 1
    return out


target_keys.launches = 0


def te_union_reference(rays, lo, hi, slack=False):
    """Plain PyTorch version of K5: f32[n_pad / RAY_BLOCK, m], per block
    of RAY_BLOCK rays and per box the least slab entry over the block's
    rays, +inf where none reaches it. ``slack`` False is the JAX function
    (limit: each ray's t_max); True is the walker's list (limit:
    list_slack(t_max); empty boxes, lo > hi, never listed)."""
    n_pad = rays.shape[1]
    nb, m = n_pad // RAY_BLOCK, lo.shape[0]
    lim = list_slack(rays[7]) if slack else rays[7]
    out = torch.empty((nb, m), dtype=torch.float32, device=rays.device)
    step = max(1, _max_pairs(rays) // (RAY_BLOCK * max(m, 1)))
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        s, e = b0 * RAY_BLOCK, b1 * RAY_BLOCK
        o, inv = _ray_slab_args(rays, s, e)
        te = _slab_entry(o, inv, lim[s:e][:, None], lo, hi)[1]
        out[b0:b1] = te.reshape(b1 - b0, RAY_BLOCK, m).amin(1)
    if slack:
        out[:, (lo > hi).any(-1)] = torch.inf
    return out


def te_union(rays, lo, hi, slack=False):
    """K5: the per-block union entry (see :func:`te_union_reference`),
    f32[n_pad / RAY_BLOCK, m] for m boxes lo/hi f32[m, 3] (clusters or
    node boxes). On CUDA tensors this launches csrc/woop_keys.cu and
    counts the launch in ``te_union.launches``; on CPU tensors it runs
    the plain version."""
    n_pad = _check_rays(rays)
    m = _check_boxes("box", lo, hi, rays.device)
    if m <= 0:
        raise ValueError("te_union: no boxes")
    if rays.device.type == "cpu":
        return te_union_reference(rays, lo, hi, slack)
    out = torch.empty((n_pad // RAY_BLOCK, m), dtype=torch.float32, device=rays.device)
    _call(_kernel_lib("woop_keys", "mq_te_union", _UNION_ARGS), rays.device, rays.data_ptr(),
          n_pad, lo.data_ptr(), hi.data_ptr(), m, int(slack), out.data_ptr())
    te_union.launches += 1
    return out


te_union.launches = 0


def node_bounds(lo, hi, nodes):
    """The boxes of nodes of ``nodes`` consecutive clusters, f32[nn, 3]
    each: the min/max of the members' boxes (which does not round, so a
    node contains its members exactly); a partial last node is filled
    with empty boxes (3e37 > -3e37), as the JAX package fills it
    (woop.py:1148-1164 there)."""
    nc = lo.shape[0]
    nn = -(-nc // nodes)
    pad = nn * nodes - nc
    if pad:
        lo = torch.cat([lo, lo.new_full((pad, 3), 3e37)])
        hi = torch.cat([hi, hi.new_full((pad, 3), -3e37)])
    return (lo.reshape(nn, nodes, 3).amin(1).contiguous(),
            hi.reshape(nn, nodes, 3).amax(1).contiguous())


def _sorted_rows(te):
    te_s, order = torch.sort(te, dim=1, stable=True)
    return te_s.contiguous(), order.to(torch.int32).contiguous()


def visit_list_reference(rays, lo, hi):
    """Plain PyTorch version of :func:`visit_list`: each row of K5's walker
    mode sorted by entry, equal entries by id (a stable sort)."""
    return _sorted_rows(te_union_reference(rays, lo, hi, slack=True))


def visit_list(rays, lo, hi):
    """Each block's near-to-far visit list over boxes lo/hi f32[m, 3]: K5
    in its walker mode with each row sorted (the JAX package sorts it in
    XLA, woop.py:1251-1257 there) → (te_s f32[nb, m], order i32[nb, m]),
    equal entries in id order. On CUDA tensors this launches
    csrc/woop_keys.cu's fused entry (the union and the row sort by one
    warp a block, m ≤ MAX_LIST_BOXES) and counts the launch in
    ``visit_list.launches``; on CPU tensors it sorts the rows of
    :func:`te_union` (its plain version there), so that the CPU route
    calls K5's wrapper where the card's launches K5."""
    n_pad = _check_rays(rays)
    m = _check_boxes("box", lo, hi, rays.device)
    if not 0 < m <= MAX_LIST_BOXES:
        raise ValueError(f"visit_list: {m} boxes, 1 to {MAX_LIST_BOXES}")
    if rays.device.type == "cpu":
        return _sorted_rows(te_union(rays, lo, hi, slack=True))
    te_s = torch.empty((n_pad // RAY_BLOCK, m), dtype=torch.float32, device=rays.device)
    order = torch.empty((n_pad // RAY_BLOCK, m), dtype=torch.int32, device=rays.device)
    _call(_kernel_lib("woop_keys", "mq_visit_list", _VISIT_LIST_ARGS), rays.device,
          rays.data_ptr(), n_pad, lo.data_ptr(), hi.data_ptr(), m, te_s.data_ptr(),
          order.data_ptr())
    visit_list.launches += 1
    return te_s, order


visit_list.launches = 0


# mq_woop_list's arguments: (rays, n_pad, rows4, boxes, nc, te_s, order, m,
# P, compact, anyhit, occ_in, out_t, out_tri, out_occ, prof, stream)
_LIST_ARGS = (_P, _I64, _P, _P, _INT, _P, _P, _INT, _INT, _INT, _INT, _P, _P, _P, _P, _P, _P)
# the walker's ``counts`` of three columns: pairs tested, tile visits,
# compacted visits (PROF_FIELDS' names)
LIST_COUNTS = ("pairs", "visits", "compact_visits")


def list_sub(nodes):
    """Clusters a sub-node of the list walker at nodes of ``nodes``
    clusters (``nodes`` itself where it has no sub-node level): a
    constant of csrc/woop_list.cu, read from the built library."""
    return _kernel_lib("woop_list", "mq_woop_list_sub", (_INT,))(nodes)


def compact_lanes(compact):
    """The reaching lanes of a warp up to which the list walker compacts a
    visit under the schedule's ``compact`` (reaching rays of a 128-ray
    block): csrc/woop_list.cu's mapping, read from the built library."""
    return _kernel_lib("woop_list", "mq_woop_list_compact_lanes", (_INT,))(compact)


def woop_list(rays, w, cluster_lo, cluster_hi, te_s, order, *, node_lo=None, node_hi=None,
              nodes=1, compact=0, anyhit=False, occluded_in=None, counts=None):
    """The list walker: K1's result (``anyhit=False``: (t f32[n_pad], tri
    i32[n_pad])) or K2's (occluded bool[n_pad], warm-started by
    ``occluded_in``), each warp of 32 rays walking its 128-ray block's
    visit list ``te_s`` / ``order`` f32/i32[nb, m] (:func:`visit_list`)
    near to far with an exact horizon exit of its own.

    ``nodes`` = 1: the list is over the clusters (m = nc); ``nodes`` = P
    > 1 (K6): over nodes of P clusters (m = ceil(nc / P)) whose boxes
    ``node_lo``/``node_hi`` f32[m, 3] are :func:`node_bounds` of the same
    padded cluster bounds: the kernel gates the node level of
    :func:`walk_boxes` (cluster_lo, cluster_hi, P, :func:`list_sub` (P)),
    which is those boxes. ``compact`` > 0 (K7, nearest only): a tile that
    :func:`compact_lanes` (compact) or fewer lanes of a warp reach is tested
    on those rays alone. Other arguments as :func:`woop_nearest`'s (on a
    card ``w`` needs its packed rows); ``counts``: None, or an int64 CUDA
    tensor of shape [n_pad / RAY_BLOCK, 3] (per CTA the pairs tested, the
    tile visits and the compacted visits, LIST_COUNTS), [n_pad /
    RAY_BLOCK] (the pairs) or [n_pad / RAY_BLOCK, 10] (the whole profile,
    PROF_FIELDS).

    On CUDA tensors this launches csrc/woop_list.cu and counts the launch
    in ``woop_list.launches`` (and in ``node_launches``,
    ``compact_launches``, ``anyhit_launches`` as it is such a walk); on
    CPU tensors it runs :func:`intersect_woop_reference` or
    :func:`intersect_woop_any_reference`: the walk changes the schedule,
    never the result.
    """
    n_pad = _check_k_inputs(rays, w, cluster_lo, cluster_hi)
    dev = rays.device
    nc, nb = cluster_lo.shape[0], n_pad // RAY_BLOCK
    if nodes < 1 or compact < 0 or (anyhit and compact):
        raise ValueError(f"woop_list: nodes={nodes}, compact={compact}, anyhit={anyhit}")
    m = -(-nc // nodes)
    _check("te_s", te_s, torch.float32, (nb, m), dev)
    _check("order", order, torch.int32, (nb, m), dev)
    if nodes > 1:
        if node_lo is None or node_hi is None:
            raise ValueError("woop_list: nodes > 1 needs node_lo and node_hi")
        _check("node_lo", node_lo, torch.float32, (m, 3), dev)
        _check("node_hi", node_hi, torch.float32, (m, 3), dev)
    if occluded_in is not None:
        if not anyhit:
            raise ValueError("woop_list: occluded_in needs anyhit=True")
        _check("occluded_in", occluded_in, torch.bool, (n_pad,), dev)
    if dev.type == "cpu":
        _refuse_counts_on_cpu(counts)
        if anyhit:
            return intersect_woop_any_reference(rays, w, occluded_in)
        return intersect_woop_reference(rays, w)
    rows4 = _aligned_rows("woop_list", w)
    boxes = walk_boxes(cluster_lo, cluster_hi, nodes, list_sub(nodes))
    prof, finish = _profile(counts, n_pad, dev, LIST_COUNTS)
    ptr = lambda x: None if x is None else x.data_ptr()
    if anyhit:
        out = torch.empty(n_pad, dtype=torch.bool, device=dev)
        outs = (None, None, out.data_ptr())
    else:
        out = (torch.empty(n_pad, dtype=torch.float32, device=dev),
               torch.empty(n_pad, dtype=torch.int32, device=dev))
        outs = (out[0].data_ptr(), out[1].data_ptr(), None)
    _call(_kernel_lib("woop_list", "mq_woop_list", _LIST_ARGS), dev, rays.data_ptr(), n_pad,
          rows4.data_ptr(), boxes.data_ptr(), nc, te_s.data_ptr(), order.data_ptr(), m, nodes,
          compact, int(anyhit), ptr(occluded_in), *outs, ptr(prof))
    finish()
    woop_list.launches += 1
    woop_list.node_launches += nodes > 1
    woop_list.compact_launches += compact > 0
    woop_list.anyhit_launches += bool(anyhit)
    return out


woop_list.launches = woop_list.node_launches = 0
woop_list.compact_launches = woop_list.anyhit_launches = 0


def check_schedule(schedule) -> TraceSchedule:
    """``schedule`` (a TraceSchedule, a tuple of its fields, or None for
    the default routes) checked: node_clusters must divide 128, as the
    JAX package asserts (woop.py:1151 there)."""
    s = TraceSchedule() if schedule is None else TraceSchedule(*schedule)
    if s.node_clusters < 0 or s.compact < 0:
        raise ValueError(f"{s}: node_clusters and compact must be >= 0")
    if s.node_clusters > 1 and 128 % s.node_clusters:
        raise ValueError(f"{s}: node_clusters must divide 128")
    return s


def schedule_nodes(schedule: TraceSchedule, nc: int) -> int:
    """The node level P a walk over ``nc`` clusters takes under
    ``schedule``: its node_clusters when that is above 1 and below nc
    (the JAX package's rule, woop.py:1135-1136 there), else 1 (flat)."""
    p = schedule.node_clusters
    return p if 1 < p < nc else 1


def target_sort_key(accel, o, d, t_max_b):
    """The target-key schedule's sort key (int64, u32 values): K4's key on
    the accel's cluster AABBs with limit t_max, the origin Morton code's
    top 6 bits, and dead rays (t_max ≤ 0) in bit 30, as the JAX package
    composes it (woop.py:1672-1685 there)."""
    n = o.shape[0]
    rays = _pack_rays(o, d, torch.zeros_like(t_max_b), t_max_b, RAY_BLOCK)
    key = target_keys(rays, accel.cluster_lo, accel.cluster_hi)[:n].long()
    morton6 = (_sort_keys(accel, o, d) & 0xFFFFFF) >> 18
    return key | morton6 | ((t_max_b <= 0.0).long() << 30)


def _walk(rays, w, lo, hi, schedule, anyhit=False, occluded_in=None):
    """K5's visit list and the walker over the padded cluster bounds
    lo/hi, at node level when the schedule's node level applies."""
    P = schedule_nodes(schedule, lo.shape[0])
    compact = 0 if anyhit else schedule.compact
    if P > 1:
        nlo, nhi = node_bounds(lo, hi, P)
        return woop_list(rays, w, lo, hi, *visit_list(rays, nlo, nhi), node_lo=nlo,
                         node_hi=nhi, nodes=P, compact=compact, anyhit=anyhit,
                         occluded_in=occluded_in)
    return woop_list(rays, w, lo, hi, *visit_list(rays, lo, hi), compact=compact,
                     anyhit=anyhit, occluded_in=occluded_in)


def sort_perm(accel, o, d, t_max_b):
    """Coherence order for bounce rays (stable sort by ``_sort_keys``;
    dead rays, t_max ≤ 0, go to trailing blocks)."""
    key = _sort_keys(accel, o, d) | ((t_max_b <= 0.0).long() << 29)
    return torch.sort(key, stable=True).indices


def k1_inputs(accel, o, d, t_min_b, t_max_b):
    """Arguments of :func:`woop_nearest` for rays in the given order:
    packed rays, the Woop table and the padded cluster bounds (the same
    two tensors every call: :func:`padded_bounds`)."""
    rays = _pack_rays(o, d, t_min_b, t_max_b, RAY_BLOCK)
    return rays, accel.woop_w, *padded_bounds(accel.cluster_lo, accel.cluster_hi)


def k2_inputs(accel, o, d, t_min_b, t_max_b):
    """Arguments of :func:`woop_any` for rays in the given order: packed
    rays, then (table, padded bounds) for the JAX package's proxy
    pre-pass (None when the scene has no proxy table; the frames do not
    run it, see :func:`intersect_woop_any`) and for the shadow sweep."""
    rays = _pack_rays(o, d, t_min_b, t_max_b, RAY_BLOCK)
    proxy = None
    if accel.woop_w_proxy is not None:
        proxy = (accel.woop_w_proxy,
                 *padded_bounds(accel.cluster_lo_proxy, accel.cluster_hi_proxy))
    w = accel.woop_w if accel.woop_w_shadow is None else accel.woop_w_shadow
    return rays, proxy, (w, *padded_bounds(accel.cluster_lo, accel.cluster_hi))


def sweep_any(rays, w, cluster_lo, cluster_hi, schedule=None, occluded_in=None):
    """The occlusion sweep over one table as the routes send it: K3 when
    :func:`streamed` says so, else the walker at node level when
    ``schedule`` has a node level that applies (K5's list, then K6), else
    K2; ``occluded_in`` warm-starts it. Arguments as :func:`woop_any`'s."""
    sched = check_schedule(schedule)
    if streamed(w):
        return woop_stream(rays, w, cluster_lo, cluster_hi, anyhit=True, occluded_in=occluded_in)
    if schedule_nodes(sched, cluster_lo.shape[0]) > 1:
        return _walk(rays, w, cluster_lo, cluster_hi, sched, anyhit=True, occluded_in=occluded_in)
    return woop_any(rays, w, cluster_lo, cluster_hi, occluded_in)


def intersect_woop_any(accel, o, d, t_min, t_max, sort_rays: bool = False, schedule=None):
    """Occlusion-only visibility sweep: bool[n] ``occluded``.

    One :func:`sweep_any` over the shadow table (sky and alpha-tested
    triangles zeroed; the full table when absent). The JAX package runs a
    K2 sweep over the proxy table first and warm-starts the shadow sweep
    with it (woop.py:1838-1848 there); that changes no result (proxy
    triangles are shadow candidates, built from the same vertices), and
    on an H100 it cost more than it saved on every route (PERF.md, section 6),
    so it is not run here. The proxy table is still built (equal to the
    JAX package's). ``sort_rays`` bins the rays as :func:`intersect_woop`
    does without a target key.
    """
    sched = check_schedule(schedule)
    n = o.shape[0]
    t_min_b = as_f32(t_min, o).expand(n).contiguous()
    t_max_b = as_f32(t_max, o).expand(n).contiguous()
    if sort_rays and n >= RAY_BLOCK:
        perm = sort_perm(accel, o, d, t_max_b)
        occ = intersect_woop_any(accel, o[perm], d[perm], t_min_b[perm], t_max_b[perm],
                                 schedule=sched)
        return torch.empty_like(occ).index_copy_(0, perm, occ)
    rays, _, shadow = k2_inputs(accel, o, d, t_min_b, t_max_b)
    return sweep_any(rays, *shadow, sched)[:n]


def _target_sorted(accel, n, sort_rays, sched) -> bool:
    """Are the rays sorted by K4's target key (a resident table of at most
    MAX_KEY_CLUSTERS clusters, sorted rays, a schedule with target_key)?"""
    return (sort_rays and n >= RAY_BLOCK and sched.target_key and not streamed(accel.woop_w)
            and accel.cluster_lo.shape[0] <= MAX_KEY_CLUSTERS)


def walks_list(accel, n, sort_rays=False, schedule=None) -> bool:
    """Does a nearest-hit trace of ``n`` rays through ``accel`` go to the
    list walker (:func:`woop_list`) rather than K1 or K3: a resident table
    under a schedule whose node level applies, that compacts, or whose
    target key sorts the rays?"""
    sched = check_schedule(schedule)
    if streamed(accel.woop_w):
        return False
    return (schedule_nodes(sched, accel.cluster_lo.shape[0]) > 1 or sched.compact > 0
            or _target_sorted(accel, n, sort_rays, sched))


def intersect_woop(accel, o, d, t_min, t_max, sort_rays: bool = False, schedule=None):
    """HitRecord-level nearest-hit trace through K1, K3 or the walker.

    ``sort_rays`` bins incoherent (bounce) rays so that each ray block has
    a tight bundle, by direction octant, dominant axis and origin Morton
    code (dead rays, t_max ≤ 0, go to trailing blocks), or by
    :func:`target_sort_key` when ``schedule.target_key`` applies (at most
    MAX_KEY_CLUSTERS clusters, a resident table); the results are
    scattered back to the caller's order. A table of more than
    RESIDENT_MAX_TRIS triangles goes to K3 whatever ``schedule`` says; a
    smaller one walks K5's list (:func:`woop_list`) when the rays are
    target-sorted, when the schedule's node level applies or when it
    compacts, and goes to K1 otherwise.
    """
    from .intersect import HitRecord

    sched = check_schedule(schedule)
    n = o.shape[0]
    t_min_b = as_f32(t_min, o).expand(n).contiguous()
    t_max_b = as_f32(t_max, o).expand(n).contiguous()
    resident = not streamed(accel.woop_w)
    walk = walks_list(accel, n, sort_rays, sched)
    perm = None
    if sort_rays and n >= RAY_BLOCK:
        if _target_sorted(accel, n, sort_rays, sched):
            perm = torch.sort(target_sort_key(accel, o, d, t_max_b), stable=True).indices
        else:
            perm = sort_perm(accel, o, d, t_max_b)
        o, d, t_min_b, t_max_b = o[perm], d[perm], t_min_b[perm], t_max_b[perm]
    args = k1_inputs(accel, o, d, t_min_b, t_max_b)
    if not resident:
        t, tri = woop_stream(*args)
    elif walk:
        t, tri = _walk(*args, sched)
    else:
        t, tri = woop_nearest(*args)
    t, tri = t[:n], tri[:n]
    t, u, v = _recompute_tuv(accel.tri_attr, o, d, t, tri)
    hr = HitRecord(t=t, tri=tri, u=u, v=v)
    if perm is None:
        return hr
    return HitRecord(*[torch.empty_like(x).index_copy_(0, perm, x) for x in hr])


# ---------------------------------------------------------------- the alpha walk

ALPHA_ADVANCE = 1e-3  # re-trace offset past a rejected surface (quake units)


class AlphaTables(NamedTuple):
    """What the alpha test of a committed hit reads (:func:`alpha_tables`):
    the scene's own tensors, never copies, since the live loop rewrites them
    in place (accel.build.refresh_dynamic) and a captured frame keeps their
    addresses."""

    tri_attr: torch.Tensor  # f32[T, 40], columns 0-8 the vertices
    st: torch.Tensor  # f32[T, 3, 2]
    texnum: torch.Tensor  # i32[T]
    needs_alpha: torch.Tensor  # bool[T]
    atlas: object  # models.types.TextureAtlas: table i32[ntex, 4], data f32[H, W, 4]


def alpha_tables(accel, atlas) -> AlphaTables:
    return AlphaTables(accel.tri_attr, accel.scene.st, accel.scene.texnum, accel.needs_alpha, atlas)


def hit_uv(st, tri, u, v):
    """Interpolated texture UV at a hit (st · barycentrics), f32[N, 2]."""
    s = st[torch.clamp_min(tri, 0).long()]  # (N, 3, 2)
    w0 = (1.0 - u - v)[..., None]
    return s[:, 0] * w0 + s[:, 1] * u[..., None] + s[:, 2] * v[..., None]


def alpha_rejects(tables: AlphaTables, tri, u, v):
    """Does the alpha test reject each hit (tri, u, v): a hit on a
    ``needs_alpha`` triangle whose texel alpha (nearest sample at the
    interpolated UV) is below ALPHA_THRESHOLD? bool[N]; False on a miss."""
    tri_c = torch.clamp_min(tri, 0).long()
    needs = tables.needs_alpha[tri_c] & (tri >= 0)
    a = atlas_mod.sample_nearest(tables.atlas, tables.texnum[tri_c],
                                 hit_uv(tables.st, tri, u, v))[..., 3]
    return needs & (a < materials.ALPHA_THRESHOLD)


def woop_alpha_reference(rays, w, tables: AlphaTables,
                         max_intersections: int = materials.MAX_INTERSECTIONS, n=None):
    """Plain PyTorch version of the alpha walk: the nearest accepted hit of
    each ray, (t f32, tri i32, u f32, v f32) each [n_pad]. Rounds of
    :func:`intersect_woop_reference` with the round loop's glue
    (intersect._alpha_round): each live ray traced over its current
    [t_min, t_max], the hit's exact (t, u, v), its alpha test; a rejected
    hit moves the ray's t_min past it and keeps it live, any other result
    is taken and ends it; a ray still live after ``max_intersections``
    rounds misses. Rays ``n`` on (padding) start dead. A round sweeps the
    live rays alone: the round loop traces a dead ray over an empty
    interval and discards its result, and a ray's sweep does not depend on
    the others'. The arguments are the kernel's, without the boxes, which
    only steer its walk."""
    n_pad = rays.shape[1]
    n = n_pad if n is None else n
    dev = rays.device
    cur_tmin = rays[6].clone()
    live = torch.arange(n_pad, device=dev) < n
    out_t = torch.full((n_pad,), BIG, dtype=torch.float32, device=dev)
    out_tri = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    out_u = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
    out_v = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
    for _ in range(max_intersections):
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        r = rays[:, idx]
        r[6] = cur_tmin[idx]
        t_k, tri = intersect_woop_reference(r, w)
        t, u, v = _recompute_tuv(tables.tri_attr, r[0:3].T, r[3:6].T, t_k, tri)
        reject = alpha_rejects(tables, tri, u, v)
        take = idx[~reject]
        for out, x in zip((out_t, out_tri, out_u, out_v), (t, tri, u, v)):
            out[take] = x[~reject]
        cur_tmin[idx[reject]] = t[reject] + ALPHA_ADVANCE
        live[take] = False
    return out_t, out_tri, out_u, out_v


# the alpha walk's entry points: (rays, n_pad, rows4, boxes, nc, block, out_t,
# out_tri, out_u, out_v, attr, attr_stride, st, texnum, needs, rect, ntex,
# texels, width, n, rounds, prof, stream)
_ALPHA_ARGS = (_P, _I64, _P, _P, _INT, _INT, _P, _P, _P, _P, _P, _INT, _P, _P, _P, _P, _INT, _P,
               _INT, _I64, _INT, _P, _P)
# the alpha walk's ``counts`` columns, per warp of 32 rays: the rounds it
# walked and the (ray, triangle) pairs its lanes tested over them
ALPHA_COUNTS = ("rounds", "pairs")


def _check_alpha_tables(tables: AlphaTables, T, device):
    nt = tables.atlas.table.shape[0]
    H, W = tables.atlas.data.shape[:2]
    _check("tri_attr", tables.tri_attr, torch.float32, (T, tables.tri_attr.shape[1]), device)
    if tables.tri_attr.shape[1] < 9:
        raise ValueError("tri_attr: columns 0-8 must hold the vertices")
    _check("st", tables.st, torch.float32, (T, 3, 2), device)
    _check("texnum", tables.texnum, torch.int32, (T,), device)
    _check("needs_alpha", tables.needs_alpha, torch.bool, (T,), device)
    _check("atlas.table", tables.atlas.table, torch.int32, (nt, 4), device)
    _check("atlas.data", tables.atlas.data, torch.float32, (H, W, 4), device)
    if nt <= 0:
        raise ValueError("atlas.table: no texture")


def _woop_alpha(entry, rays, w, cluster_lo, cluster_hi, tables, max_intersections, n, counts):
    """The alpha walks' checks, CPU route and launch of ``entry`` (a C
    entry point of csrc/woop_alpha.cu); returns (t, tri, u, v)."""
    n_pad = _check_k_inputs(rays, w, cluster_lo, cluster_hi)
    n = n_pad if n is None else n
    if not 0 <= n <= n_pad or max_intersections < 0:
        raise ValueError(f"{entry}: n={n} of {n_pad} rays, max_intersections={max_intersections}")
    _check_alpha_tables(tables, w.shape[0] // 3, rays.device)
    if rays.device.type == "cpu":
        _refuse_counts_on_cpu(counts)
        return woop_alpha_reference(rays, w, tables, max_intersections, n)
    if counts is not None:
        _check("counts", counts, torch.int64, (n_pad // 32, len(ALPHA_COUNTS)), rays.device)
        counts.zero_()
    dev = rays.device
    out = (torch.empty(n_pad, dtype=torch.float32, device=dev),
           torch.empty(n_pad, dtype=torch.int32, device=dev),
           torch.empty(n_pad, dtype=torch.float32, device=dev),
           torch.empty(n_pad, dtype=torch.float32, device=dev))
    rows4 = _aligned_rows(entry, w)
    boxes = walk_boxes(cluster_lo, cluster_hi, *node_sizes("woop_alpha"))
    atlas = tables.atlas
    _call(_kernel_lib("woop_alpha", entry, _ALPHA_ARGS), dev, rays.data_ptr(), n_pad,
          rows4.data_ptr(), boxes.data_ptr(), cluster_lo.shape[0], RAY_BLOCK,
          *(x.data_ptr() for x in out),
          tables.tri_attr.data_ptr(), tables.tri_attr.shape[1], tables.st.data_ptr(),
          tables.texnum.data_ptr(), tables.needs_alpha.data_ptr(), atlas.table.data_ptr(),
          atlas.table.shape[0], atlas.data.data_ptr(), atlas.data.shape[1], n,
          max_intersections, None if counts is None else counts.data_ptr())
    return out


def woop_nearest_alpha(rays, w, cluster_lo, cluster_hi, tables: AlphaTables,
                       max_intersections: int = materials.MAX_INTERSECTIONS, n=None,
                       counts=None):
    """The alpha walk on K1's walk: the whole alpha loop of
    ``intersect.trace_nearest`` in one launch, for a table of up to
    RESIDENT_MAX_TRIS triangles. Returns (t f32, tri i32, u f32, v f32),
    each [n_pad]: each ray's nearest hit that the alpha test accepts
    (BIG, -1, 0, 0 on a miss and after ``max_intersections`` rejecting
    rounds).

    rays, w, cluster_lo, cluster_hi as :func:`woop_nearest`'s; ``tables``
    (:func:`alpha_tables`) the alpha test's; ``n`` the rays that are not
    padding (all when None). On CUDA tensors this launches
    csrc/woop_alpha.cu and counts the launch in
    ``woop_nearest_alpha.launches``; on CPU tensors it runs
    :func:`woop_alpha_reference`. ``counts``: None (the frame path), or an
    int64 CUDA tensor [n_pad / 32, 2] that gets per warp ALPHA_COUNTS (the
    rounds walked, the pairs tested)."""
    out = _woop_alpha("mq_woop_nearest_alpha", rays, w, cluster_lo, cluster_hi, tables,
                      max_intersections, n, counts)
    if rays.is_cuda:
        woop_nearest_alpha.launches += 1
    return out


woop_nearest_alpha.launches = 0


def woop_stream_alpha(rays, w, cluster_lo, cluster_hi, tables: AlphaTables,
                      max_intersections: int = materials.MAX_INTERSECTIONS, n=None,
                      counts=None):
    """The alpha walk on K3's walk (node lists): :func:`woop_nearest_alpha`'s
    result for a table of any size up to MAX_STREAM_CLUSTERS clusters,
    arguments as its. Counts its launches in
    ``woop_stream_alpha.launches``."""
    nc = cluster_lo.shape[0]
    if nc > MAX_STREAM_CLUSTERS:
        raise ValueError(f"woop_stream_alpha: {nc} clusters, at most {MAX_STREAM_CLUSTERS}")
    out = _woop_alpha("mq_woop_stream_alpha", rays, w, cluster_lo, cluster_hi, tables,
                      max_intersections, n, counts)
    if rays.is_cuda:
        woop_stream_alpha.launches += 1
    return out


woop_stream_alpha.launches = 0


def intersect_woop_alpha(accel, atlas, o, d, t_min, t_max,
                         max_intersections: int = materials.MAX_INTERSECTIONS,
                         sort_rays: bool = False):
    """HitRecord-level alpha loop in one launch: K1's or K3's alpha walk,
    by the table's size (:func:`streamed`). ``sort_rays`` bins the rays
    once as :func:`intersect_woop` does (by their starting t_max) and
    scatters the results back; the walk's result for a ray does not
    depend on its neighbours, so this equals the round loop, which sorts
    every round. Reads nothing from the host."""
    from .intersect import HitRecord

    n = o.shape[0]
    t_min_b = as_f32(t_min, o).expand(n).contiguous()
    t_max_b = as_f32(t_max, o).expand(n).contiguous()
    perm = None
    if sort_rays and n >= RAY_BLOCK:
        perm = sort_perm(accel, o, d, t_max_b)
        o, d, t_min_b, t_max_b = o[perm], d[perm], t_min_b[perm], t_max_b[perm]
    walk = woop_stream_alpha if streamed(accel.woop_w) else woop_nearest_alpha
    out = walk(*k1_inputs(accel, o, d, t_min_b, t_max_b), alpha_tables(accel, atlas),
               max_intersections, n)
    hr = HitRecord(*(x[:n] for x in out))
    if perm is None:
        return hr
    return HitRecord(*[torch.empty_like(x).index_copy_(0, perm, x) for x in hr])
