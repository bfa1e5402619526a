"""The trace schedules (woop.TraceSchedule): K4 (target keys), K5 (block
union entries) and the list walker (K6 nodes, K7 compacted visits), port
against the JAX package, on the same inputs.

- K4's and K5's plain versions against the JAX kernels in interpret
  mode, bit for bit, with dead rays, padding rays, origins inside several
  boxes and a ray with a NaN coordinate; the composed sort key against
  the JAX composition.
- ``intersect_woop`` on CPU tensors under every schedule (its glue runs
  the plain versions) against the CPU oracle and the flat sweep: twins of
  tests/test_accel.py's target-key and node-hierarchy tests, with the
  wrappers each route calls.
- A torch model of the walker's schedule (K5 list, near-to-far walk,
  horizon exit, node gate then member gates, the compaction split) gives
  exactly the plain versions' results, and mutants of it fail.
- One 32×18 path-traced frame of city(1600, 7) (252 clusters: the target
  key applies) under TraceSchedule(True, 8, 32), traced through
  ``intersect_woop``'s glue on CPU tensors, against the JAX package's
  frame with tests/test_torch_slice.py's bounds.

The CUDA kernels cannot run here; the ``cuda``-marked test and
chip_smoke.py hold them against their plain versions on the card.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.accel import build_accel as j_build_accel
from merian_quake_tpu.accel import woop as j_woop
from merian_quake_tpu.models.procedural import city as j_city
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.models.types import build_scene_from_soup as j_soup
from merian_quake_tpu.renderer import render_sequence as j_render_sequence
from merian_quake_tpu_torch.accel import build_accel, intersect, woop
from merian_quake_tpu_torch.accel.build import cluster_aabbs
from merian_quake_tpu_torch.models.procedural import city
from merian_quake_tpu_torch.models.types import RenderConfig, build_scene_from_soup
from merian_quake_tpu_torch.renderer import render_sequence
from torch_walk_model import compact_lanes, list_sub, model_walk

# the module (the package's ``intersect`` attribute is the function)
intersect_mod = importlib.import_module("merian_quake_tpu_torch.accel.intersect")

# The suite runs several test processes side by side on a few cores;
# torch would start one thread per core in each and oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

T_RTOL, T_ATOL = 1e-4, 1e-3  # tests/test_accel.py's tolerance against the oracle
CITY = dict(n_buildings=1600, seed=7)  # 16,128 triangles, 252 clusters
SENTINEL = (0xFF << 22) | (0xFF << 14) | (0xFF << 6)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _soup(rng, n_tri, spread=6.0):
    c = rng.uniform(-40, 40, (n_tri, 1, 3))
    tri = (c + rng.uniform(-spread, spread, (n_tri, 3, 3))).astype(np.float32)
    return tri[:, 0], tri[:, 1], tri[:, 2]


def _rays(rng, n, misses=False):
    o = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if misses:  # half of them aimed away from the soup
        o[: n // 2] = 500.0
        d[: n // 2] = np.abs(d[: n // 2])
    return o, d


def _soup_pair(rng, n_clusters):
    v0, v1, v2 = _soup(rng, 64 * n_clusters)
    return (v0, v1, v2), j_build_accel(j_soup(v0, v1, v2)), build_accel(
        build_scene_from_soup(v0, v1, v2, device="cpu"))


def _key_rays(rng, tris, n=300):
    """Rays for K4/K5: 20 origins on triangle vertices (inside several
    boxes: entry 0 for each), 20% dead (t_max = -1), n not a multiple of
    128 (the packing adds dead padding rays), one NaN origin, one NaN
    direction."""
    o, d = _rays(rng, n)
    o[:20] = tris[0][:20]
    o[20, 1] = np.nan
    d[21, 0] = np.nan
    t_max = np.where(rng.random(n) < 0.2, -1.0, 1e4).astype(np.float32)
    return woop._pack_rays(torch.from_numpy(o), torch.from_numpy(d), torch.zeros(n),
                           torch.from_numpy(t_max), woop.RAY_BLOCK)


class _Spy:
    """Records which kernel wrappers a trace calls (on the CPU each runs
    its plain version, so the launch counters stay at 0)."""

    NAMES = ("woop_nearest", "woop_any", "woop_stream", "target_keys", "te_union", "woop_list")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in self.NAMES:
            fn = getattr(woop, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                tag = _name
                if _name == "woop_list":
                    tag += f"(P={k.get('nodes', 1)}, compact={k.get('compact', 0)}" + (
                        ", any)" if k.get("anyhit") else ")")
                self.calls.append(tag)
                return _fn(*a, **k)

            monkeypatch.setattr(woop, name, wrapped)


# ------------------------------------------------------------------ K4, K5


@pytest.mark.parametrize("n_clusters", [8, 30])
def test_target_keys_plain_matches_jax(rng, n_clusters):
    tris, ja, ta = _soup_pair(rng, n_clusters)
    rays = _key_rays(rng, tris)
    ref = np.asarray(j_woop._target_keys(jnp.asarray(_np(rays)), ja.cluster_lo, ja.cluster_hi,
                                         woop.RAY_BLOCK, interpret=True))
    ours = _np(woop.target_keys(rays, ta.cluster_lo, ta.cluster_hi))
    np.testing.assert_array_equal(ours, ref)
    t_max = _np(rays[7])
    assert (ours[t_max < 0] == SENTINEL).all()  # dead and padding rays reach nothing
    assert (ours[20:22] == SENTINEL).all()  # NaN propagates through the slab, as in jnp
    assert len(np.unique(ours[t_max > 0])) > 10
    # origins inside several boxes: entry 0 for each, the lowest ids kept
    inside = _np(woop.te_union_reference(rays[:, :128], ta.cluster_lo, ta.cluster_hi))
    assert inside.min() == 0.0


def test_target_keys_cluster_255_is_the_sentinel():
    """With 256 boxes a ray that reaches only box 255 gets the all-sentinel
    key, as in the JAX package (its ids have 8 bits)."""
    lo = torch.full((256, 3), 100.0)
    hi = torch.full((256, 3), 101.0)
    lo[255], hi[255] = torch.tensor([4.0, -1.0, -1.0]), torch.tensor([5.0, 1.0, 1.0])
    o, d = torch.zeros((128, 3)), torch.tensor([[1.0, 0.0, 0.0]]).expand(128, 3)
    rays = woop._pack_rays(o, d.contiguous(), torch.zeros(128), torch.full((128,), 1e4), 128)
    assert (_np(woop.target_keys(rays, lo, hi)) == SENTINEL).all()
    assert float(woop.te_union(rays, lo, hi)[0, 255]) == 4.0


def test_sort_key_matches_jax_composition(rng):
    """K4's key | the Morton tail | the dead bit, as woop.py:1672-1685."""
    tris, ja, ta = _soup_pair(rng, 12)
    n = 500
    o, d = _rays(rng, n)
    t_max = np.where(rng.random(n) < 0.2, -1.0, 1e4).astype(np.float32)
    oj, dj, tj = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    rays_tmp = j_woop._pack_rays(oj, dj, jnp.zeros((n,)), tj, 128)
    key = j_woop._target_keys(rays_tmp, ja.cluster_lo, ja.cluster_hi, 128,
                              interpret=True)[:n].astype(jnp.uint32)
    morton6 = (j_woop._sort_keys(ja, oj, dj) & jnp.uint32(0xFFFFFF)) >> 18
    ref = np.asarray((key | morton6 | ((tj <= 0.0).astype(jnp.uint32) << 30)).astype(jnp.int32))
    ours = _np(woop.target_sort_key(ta, torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(t_max)))
    np.testing.assert_array_equal(ours, ref.astype(np.int64))


@pytest.mark.parametrize("boxes", ["clusters", "nodes8"])
def test_te_union_plain_matches_jax(rng, boxes):
    tris, ja, ta = _soup_pair(rng, 30)
    rays = _key_rays(rng, tris)
    lo, hi = ta.cluster_lo, ta.cluster_hi
    jlo, jhi = np.asarray(ja.cluster_lo), np.asarray(ja.cluster_hi)
    if boxes == "nodes8":  # the JAX package's node boxes (woop.py:1152-1164)
        jlo = np.concatenate([jlo, np.full((2, 3), 3e37, np.float32)]).reshape(4, 8, 3).min(1)
        jhi = np.concatenate([jhi, np.full((2, 3), -3e37, np.float32)]).reshape(4, 8, 3).max(1)
        lo, hi = woop.node_bounds(lo, hi, 8)
        np.testing.assert_array_equal(_np(lo), jlo)
        np.testing.assert_array_equal(_np(hi), jhi)
    ref = np.asarray(j_woop._te_union(jnp.asarray(_np(rays)), jnp.asarray(jlo), jnp.asarray(jhi),
                                      woop.RAY_BLOCK, interpret=True))
    ours = _np(woop.te_union(rays, lo, hi))
    np.testing.assert_array_equal(ours, ref)
    assert np.isfinite(ours).any() and (ours == 0.0).any()
    # the walker's mode: a later limit (list_slack(t_max)) over the same
    # boxes lists a superset, never with a later entry
    walk = _np(woop.te_union(rays, lo, hi, slack=True))
    assert (walk <= ours).all()


# ------------------------------------------------------------------ routes


SCHEDULES = {
    "target": woop.TraceSchedule(target_key=True),
    "nodes8": woop.TraceSchedule(node_clusters=8),
    "nodes16": woop.TraceSchedule(node_clusters=16),
    "nodes8_compact32": woop.TraceSchedule(node_clusters=8, compact=32),
    "nodes16_compact32": woop.TraceSchedule(node_clusters=16, compact=32),
    "compact32": woop.TraceSchedule(compact=32),
    "all": woop.TraceSchedule(True, 8, 32),
}


def _expected_calls(name, sort_rays):
    s = SCHEDULES[name]
    P = s.node_clusters if s.node_clusters > 1 else 1
    calls = ["target_keys"] if s.target_key and sort_rays else []
    if s.target_key and sort_rays or P > 1 or s.compact:
        return calls + ["te_union", f"woop_list(P={P}, compact={s.compact})"]
    return calls + ["woop_nearest"]


@pytest.mark.parametrize("sort_rays", [False, True])
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_oracle_and_flat_sweep(rng, monkeypatch, name, sort_rays):
    """Twins of test_accel.py:414 (target key) and :455 (nodes, P = 8 and
    16, compact 0 and 32, partial last node): 30 clusters, 20% masked
    rays, misses."""
    tris, _, ta = _soup_pair(rng, 30)
    n = 512
    o, d = (torch.from_numpy(x) for x in _rays(rng, n))
    t_max = torch.from_numpy(np.where(rng.random(n) < 0.2, -1.0, 1e4).astype(np.float32))
    flat = woop.intersect_woop(ta, o, d, 0.0, t_max)
    spy = _Spy(monkeypatch)
    hr = woop.intersect_woop(ta, o, d, 0.0, t_max, sort_rays=sort_rays, schedule=SCHEDULES[name])
    assert spy.calls == _expected_calls(name, sort_rays)
    for a, b in zip(hr, flat):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ho = intersect(ta, o, d, 0.0, t_max)
    np.testing.assert_array_equal(_np(hr.tri), _np(ho.tri))
    hit = _np(ho.tri) >= 0
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(_np(hr.t)[hit], _np(ho.t)[hit], rtol=T_RTOL, atol=T_ATOL)


@pytest.mark.parametrize("name", ["nodes8", "nodes16", "all"])
def test_anyhit_with_nodes_matches_flat_sweep(rng, monkeypatch, name):
    """Any-hit walks nodes when the schedule has a node level (and ignores
    the target key and compaction); the table has a proxy table, whose
    pre-pass the port does not run (it changes no ray and cost more than
    it saved on the card: PERF.md, section 6)."""
    tris, _, ta = _soup_pair(rng, 70)  # 4,480 triangles: a proxy table
    assert ta.woop_w_proxy is not None
    n = 512
    o, d = (torch.from_numpy(x) for x in _rays(rng, n))
    t_max = torch.from_numpy(rng.uniform(1.0, 200.0, n).astype(np.float32))
    flat = woop.intersect_woop_any(ta, o, d, 1e-3, t_max)
    spy = _Spy(monkeypatch)
    occ = woop.intersect_woop_any(ta, o, d, 1e-3, t_max, sort_rays=True, schedule=SCHEDULES[name])
    P = SCHEDULES[name].node_clusters
    assert spy.calls == ["te_union", f"woop_list(P={P}, compact=0, any)"]
    torch.testing.assert_close(occ, flat, rtol=0, atol=0)
    assert occ.any() and (~occ).any()


def test_schedule_routing_rules(rng, monkeypatch):
    """The JAX package's size rules: no target key above 256 clusters, no
    node level at or above nc clusters a node, nothing on a table routed to
    K3; a node level that does not divide 128 raises."""
    _, _, ta = _soup_pair(rng, 8)
    o, d = (torch.from_numpy(x) for x in _rays(rng, 256))
    spy = _Spy(monkeypatch)
    woop.intersect_woop(ta, o, d, 0.0, 1e4, schedule=woop.TraceSchedule(node_clusters=8))
    assert spy.calls == ["woop_nearest"]  # 8 clusters: one node would hold them all
    spy.calls.clear()
    monkeypatch.setattr(woop, "MAX_KEY_CLUSTERS", 4)
    woop.intersect_woop(ta, o, d, 0.0, 1e4, sort_rays=True, schedule=woop.TraceSchedule(True))
    assert spy.calls == ["woop_nearest"]
    spy.calls.clear()
    monkeypatch.setattr(woop, "RESIDENT_MAX_TRIS", 0)
    woop.intersect_woop(ta, o, d, 0.0, 1e4, sort_rays=True, schedule=woop.TraceSchedule(True, 2, 8))
    woop.intersect_woop_any(ta, o, d, 1e-3, 1e4, schedule=woop.TraceSchedule(True, 2, 8))
    assert spy.calls == ["woop_stream", "woop_stream"]
    for bad in ((False, 3, 0), (False, -1, 0), (False, 0, -2)):
        with pytest.raises(ValueError):
            woop.intersect_woop(ta, o, d, 0.0, 1e4, schedule=bad)


def test_list_wrappers_reject_bad_inputs(rng):
    _, _, ta = _soup_pair(rng, 10)
    o, d = (torch.from_numpy(x) for x in _rays(rng, 256))
    rays, w, lo, hi = woop.k1_inputs(ta, o, d, torch.zeros(256), torch.full((256,), 1e4))
    te_s, order = woop.visit_list(rays, lo, hi)
    nlo, nhi = woop.node_bounds(lo, hi, 4)
    te_n, order_n = woop.visit_list(rays, nlo, nhi)
    good = torch.zeros(256, dtype=torch.bool)
    for args, kw in (
        ((rays, w, lo, hi, te_s[:, :5].contiguous(), order), {}),  # list width
        ((rays, w, lo, hi, te_s, order.long()), {}),  # order dtype
        ((rays, w, lo, hi, te_n, order_n), {"nodes": 4}),  # nodes without node boxes
        ((rays, w, lo, hi, te_s, order), {"nodes": 4, "node_lo": nlo, "node_hi": nhi}),
        ((rays, w, lo, hi, te_s, order), {"compact": 8, "anyhit": True}),
        ((rays, w, lo, hi, te_s, order), {"occluded_in": good}),  # a warm start needs anyhit
        ((rays, w, lo, hi, te_s, order), {"counts": torch.zeros((2, 3), dtype=torch.int64)}),
    ):
        with pytest.raises(ValueError):
            woop.woop_list(*args, **kw)
    with pytest.raises(ValueError):
        woop.target_keys(rays, torch.zeros((257, 3)), torch.zeros((257, 3)))
    with pytest.raises(ValueError):
        woop.te_union(rays[:, :200], lo, hi)
    # the CPU wrappers are the plain versions
    torch.testing.assert_close(woop.woop_list(rays, w, lo, hi, te_n, order_n, nodes=4,
                                              node_lo=nlo, node_hi=nhi, compact=16),
                               woop.intersect_woop_reference(rays, w), rtol=0, atol=0)


# ------------------------------------------------------------------ the walker's schedule


def _model_walk(rays, w, lo, hi, nodes=1, compact=0, anyhit=False, occluded_in=None,
                mutant=None, raw_bounds=None):
    """torch model of csrc/woop_list.cu's schedule: the block-list source
    of tests/torch_walk_model.py's walk, one warp of 32 rays at a time:
    1. visit list: K5 in its walker mode (limit list_slack(t_max), empty
       boxes never listed) over the clusters, or over nodes of ``nodes``
       clusters (woop.node_bounds), each row sorted near to far;
    2. each warp walks its block's list BATCH entries a step, keeping the
       entries within its own horizon (the largest of its lanes' limits),
       gating them with K5's slab at the current limits; at node level a
       reached node's members (or sub-nodes, then their members, above 32
       clusters a node) are gated next;
    3. tiles fetched one ahead (limits lag by a tile), a tile that
       1..compact_lanes(compact) lanes reach tested triangle per lane
       (nearest only), a denser one ray per lane; any-hit ends a warp's
       walk once every live lane is occluded.
    Mutants: torch_walk_model.model_walk's."""
    blo, bhi = woop.node_bounds(lo, hi, nodes) if nodes > 1 else (lo, hi)
    return model_walk(rays, w, lo, hi, (nodes, list_sub(nodes)), None, anyhit=anyhit,
                      occluded_in=occluded_in, mutant=mutant,
                      block_list=woop.visit_list(rays, blo, bhi),
                      compact=0 if anyhit else compact_lanes(compact), raw_bounds=raw_bounds)


def _city_primary(bundle, width, height):
    from merian_quake_tpu_torch.ops import camera
    from merian_quake_tpu_torch.render import layout

    u = bundle.uniforms
    px, py = layout.gen_pixels(width, height, device="cpu")
    d = camera.ray_dir(px.float(), py.float(), width, height, u.cam_u, u.cam_w, u.fov_tan_half)
    return u.cam_x.expand_as(d).contiguous(), d


def _bounce(bundle, accel, width, height):
    """The path tracer's first bounce at frame 0 (dead rays: t_max = -1),
    in pixel order, and the gbuffer points."""
    from merian_quake_tpu_torch.ops import bsdf, linalg, rng
    from merian_quake_tpu_torch.render import layout
    from merian_quake_tpu_torch.render.gbuffer import render_gbuffer
    from merian_quake_tpu_torch.render.hit import decompress_hit

    cfg = RenderConfig(width=width, height=height)
    cur = decompress_hit(render_gbuffer(accel, bundle.atlas, bundle.uniforms, cfg).hits)
    px, py = layout.gen_pixels(width, height, device="cpu")
    _, u3 = rng.uniform3(rng.seed_pixel(px, py, 0, cfg.seed))
    wo = bsdf.sample(cur.wi, cur.normal, bsdf.roughness_to_alpha(cur.roughness), u3)
    live = (linalg.dot(wo, cur.geo_normal) > 1e-3) & (cur.albedo >= 1e-7).any(-1)
    return cur.pos - cur.wi * 1e-3, wo, torch.where(live, 1e4, -1.0), cur.pos


@pytest.fixture(scope="module")
def city_1600():
    bundle = city(**CITY, device="cpu")
    return bundle, build_accel(bundle.scene, bundle.atlas)


def _planes():
    """A table whose nodes of 8 clusters each lie in one plane x = 10k
    (unit squares on a 16 × 16 grid), built without the median split, and
    rays from x = 0 along +x that end exactly at their nearest hit
    (t_max = that hit's t): a flat node box is entered at the hit itself,
    so the rounded slab puts the entry past t_max for some of them, and a
    node gate without the slack would skip their hits."""
    quads = []
    for plane in range(3):
        x = 10.0 * (plane + 1)
        for gy in range(16):
            for gz in range(16):
                y, z = gy - 8.0, gz - 8.0
                a, b, c, e = ([x, y, z], [x, y + 1, z], [x, y + 1, z + 1], [x, y, z + 1])
                quads += [(a, b, c), (a, c, e)]  # front faces for +x rays
    tri = np.asarray(quads, np.float32)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    w, cand = woop.build_woop(v0, v1, v2, np.ones(len(tri), bool))
    lo, hi = (torch.from_numpy(x) for x in cluster_aabbs(v0, v1, v2, cand))
    rng = np.random.default_rng(3)
    n = 512
    o = np.zeros((n, 3), np.float32)
    o[:, 1:] = rng.uniform(-6, 6, (n, 2))
    d = np.concatenate([np.ones((n, 1)), rng.uniform(-0.3, 0.3, (n, 2))], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d, w = torch.from_numpy(o), torch.from_numpy(d), woop.pack_table(torch.from_numpy(w))
    rays = woop._pack_rays(o, d, torch.zeros(n), torch.full((n,), 1e4), 128)
    t_hit = woop.intersect_woop_reference(rays, w)[0][:n]
    t_max = torch.where(t_hit < 1e4, t_hit, 1e4)
    rays = woop._pack_rays(o, d, torch.zeros(n), t_max, 128)
    # A node gate decides for the whole block, so the rays whose flat node
    # box (the plane's) is entered past t_max while they still hit there
    # get blocks of their own: 8 such rays, each 128 times.
    t_ref, tri_ref = woop.intersect_woop_reference(rays, w)
    nlo, nhi = woop.node_bounds(lo, hi, 8)
    inv = rays[3:6, :n].T.reciprocal()
    entered = woop._slab_entry(o[:, None, :], inv[:, None, :], t_max[:, None], nlo, nhi)[0]
    node = tri_ref[:n].clamp_min(0).long() // (64 * 8)
    edge = ((tri_ref[:n] >= 0) & ~entered[torch.arange(n), node]).nonzero()[:8, 0]
    assert len(edge) == 8
    rep = edge.repeat_interleave(128)
    o, d, t_max = torch.cat([o, o[rep]]), torch.cat([d, d[rep]]), torch.cat([t_max, t_max[rep]])
    rays = woop._pack_rays(o, d, torch.zeros(len(o)), t_max, 128)
    return rays, w, lo.contiguous(), hi.contiguous()


def _walk_inputs(name, rng, city_1600):
    """(rays, w, lo, hi) of a nearest-hit population, or (rays, shadow,
    proxy) of an any-hit one, with the frame's padded bounds."""
    if name == "planes":
        return _planes()
    if name == "soup":
        v0, v1, v2 = _soup(rng, 64 * 30)
        acc = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
        o, d = (torch.from_numpy(x) for x in _rays(rng, 512, misses=True))
        t_max = torch.from_numpy(rng.uniform(1.0, 200.0, 512).astype(np.float32))
        return woop.k1_inputs(acc, o, d, torch.zeros(512), t_max)
    bundle, acc = city_1600
    if name == "city_primary":
        o, d = _city_primary(bundle, 32, 16)
        return woop.k1_inputs(acc, o, d, torch.zeros(512), torch.full((512,), 1e4))
    o, d, t_max, pos = _bounce(bundle, acc, 32, 16)
    if name == "city_bounce_target":
        perm = torch.sort(woop.target_sort_key(acc, o, d, t_max), stable=True).indices
        return woop.k1_inputs(acc, o[perm], d[perm], torch.full((512,), 1e-3), t_max[perm])
    g = torch.Generator().manual_seed(5)  # city_shadow: to random points in the scene
    to = acc.world_lo + (acc.world_hi - acc.world_lo) * torch.rand(pos.shape, generator=g)
    dist = torch.linalg.vector_norm(to - pos, dim=-1)
    rays, proxy, shadow = woop.k2_inputs(acc, pos, (to - pos) / dist[:, None],
                                         torch.full((512,), 1e-3),
                                         torch.clamp_min(dist - 2e-3, 1e-3))
    return rays, shadow, proxy


NEAREST_MODES = [(1, 0), (1, 32), (8, 0), (8, 32), (16, 0), (16, 32)]


@pytest.mark.parametrize("name", ["soup", "city_primary", "city_bounce_target", "planes"])
def test_walk_model_matches_plain_version(rng, city_1600, name):
    args = _walk_inputs(name, rng, city_1600)
    t_ref, tri_ref = woop.intersect_woop_reference(args[0], args[1])
    assert (tri_ref >= 0).any() and (name.startswith("city") or (tri_ref[:512] < 0).any())
    for nodes, compact in NEAREST_MODES:
        t_mod, tri_mod = _model_walk(*args, nodes=nodes, compact=compact)
        torch.testing.assert_close(tri_mod, tri_ref, rtol=0, atol=0)
        torch.testing.assert_close(t_mod, t_ref, rtol=0, atol=0)


@pytest.mark.parametrize("nodes", [1, 8])
def test_walk_model_anyhit_matches_plain_version(rng, city_1600, nodes):
    rays, shadow, proxy = _walk_inputs("city_shadow", rng, city_1600)
    dense = woop.intersect_woop_any_reference(rays, shadow[0])
    assert dense[:512].any() and (~dense[:512]).any()
    torch.testing.assert_close(_model_walk(rays, *shadow, nodes=nodes, anyhit=True), dense,
                               rtol=0, atol=0)
    pre = woop.intersect_woop_any_reference(rays, proxy[0])
    assert pre[:512].any()
    torch.testing.assert_close(_model_walk(rays, *shadow, nodes=nodes, anyhit=True,
                                           occluded_in=pre), dense, rtol=0, atol=0)


@pytest.mark.parametrize("nodes,compact", [(32, 0), (64, 32), (128, 0)])
def test_walk_model_sub_nodes_match_plain_version(rng, city_1600, nodes, compact):
    """Nodes of 32 clusters (members gated straight, 32 votes a word) and
    of 64 and 128 (the sub-node level of 8) on city(1600)'s target-sorted
    bounce and primary rays."""
    for name in ("city_bounce_target", "city_primary"):
        args = _walk_inputs(name, rng, city_1600)
        t_ref, tri_ref = woop.intersect_woop_reference(args[0], args[1])
        t_mod, tri_mod = _model_walk(*args, nodes=nodes, compact=compact)
        torch.testing.assert_close(tri_mod, tri_ref, rtol=0, atol=0)
        torch.testing.assert_close(t_mod, t_ref, rtol=0, atol=0)


@pytest.mark.parametrize("nodes", [1, 2, 4, 8, 16, 32, 64, 128])
def test_walk_boxes_node_level_is_node_bounds(city_1600, nodes):
    """The walker gates the node level of walk_boxes(lo, hi, P, list_sub(P))
    and K5 lists node_bounds(lo, hi, P) of the same padded bounds: the two
    must be the same boxes, or the horizon exit is no longer exact."""
    acc = city_1600[1]
    lo, hi = woop.padded_bounds(acc.cluster_lo, acc.cluster_hi)
    nn = -(-lo.shape[0] // nodes)
    boxes = woop.walk_boxes(lo, hi, nodes, list_sub(nodes))
    nlo, nhi = woop.node_bounds(lo, hi, nodes)
    torch.testing.assert_close(boxes[:nn, 0:3], nlo, rtol=0, atol=0)
    torch.testing.assert_close(boxes[:nn, 4:7], nhi, rtol=0, atol=0)
    torch.testing.assert_close(boxes[:nn, 3], (nlo > nhi).any(-1).float(), rtol=0, atol=0)
    torch.testing.assert_close(boxes[-lo.shape[0]:, 0:3], lo, rtol=0, atol=0)


def _unpadded(lo, hi):
    """The cluster bounds without woop._pad_bounds' margin."""
    return lo + (lo.abs() * 1e-5 + 1e-3), hi - (hi.abs() * 1e-5 + 1e-3)


@pytest.mark.parametrize("mutant,nodes,compact", [
    ("early_exit", 1, 0), ("early_exit", 8, 32), ("node_no_slack", 8, 0),
    ("compact_drops_last", 1, 32), ("compact_drops_last", 8, 32),
    ("horizon_next_entry", 8, 0), ("unpadded_node_boxes", 8, 0),
    ("compact_wrong_lanes", 8, 32),
])
def test_walk_model_mutants_fail(rng, city_1600, mutant, nodes, compact):
    """Each mutant of the walker's schedule gives another result than the
    plain version on at least one of the populations."""
    differ = 0
    for name in ("soup", "city_primary", "city_bounce_target", "planes"):
        args = _walk_inputs(name, rng, city_1600)
        t_ref, tri_ref = woop.intersect_woop_reference(args[0], args[1])
        t_mod, tri_mod = _model_walk(*args, nodes=nodes, compact=compact, mutant=mutant,
                                     raw_bounds=_unpadded(*args[2:4]))
        differ += int((tri_mod != tri_ref).sum())
    assert differ > 0


def test_walk_model_anyhit_stopping_at_first_occluded_lane_fails(rng, city_1600):
    """Any-hit must walk on until every live lane of the warp is occluded:
    a walk that stops at the first occluded lane misses the occluders of
    the others."""
    rays, shadow, _ = _walk_inputs("city_shadow", rng, city_1600)
    dense = woop.intersect_woop_any_reference(rays, shadow[0])
    occ = _model_walk(rays, *shadow, nodes=8, anyhit=True, mutant="anyhit_first_occluded")
    assert int((occ != dense).sum()) > 0


# ------------------------------------------------------------------ the frame


def test_scheduled_pt_frame_matches_jax(monkeypatch):
    """One 32×18 path-traced frame (2 spp, max path length 3) of city(1600,
    7) under TraceSchedule(True, 8, 32), every trace sent through
    ``intersect_woop``'s glue on CPU tensors (K4, K5 and the walker run
    their plain versions), with tests/test_torch_slice.py's bounds against
    the JAX package's frame."""
    cfg = dict(width=32, height=18, spp=2, max_path_length=3)
    j_state, j_out = j_render_sequence(j_city(**CITY), JConfig(**cfg), frames=1)
    jax.block_until_ready(j_out["ldr"])

    def through_woop(accel, o, d, t_min, t_max, sort_rays=False, schedule=None):
        return woop.intersect_woop(accel, o, d, t_min, t_max, sort_rays=sort_rays,
                                   schedule=schedule)

    monkeypatch.setattr(intersect_mod, "intersect", through_woop)
    spy = _Spy(monkeypatch)
    t_state, t_out = render_sequence(city(**CITY, device="cpu"), RenderConfig(**cfg), frames=1,
                                     device="cpu", schedule=woop.TraceSchedule(True, 8, 32))
    # 1 primary + 2 spp × 2 sorted bounces: no K1, 4 K4, 5 K5, 5 walks
    assert spy.calls.count("target_keys") == 4 and spy.calls.count("te_union") == 5
    assert spy.calls.count("woop_list(P=8, compact=32)") == 5 and len(spy.calls) == 14

    def agree(ours, ref, share, mean, pixels=None):
        ours, ref = ours.numpy(), np.asarray(ref)
        assert ours.shape == ref.shape and np.isfinite(ours).all()
        diff = np.abs(ours - ref)
        per_pixel = diff.max(-1) if diff.ndim == 3 else diff
        if pixels is not None:
            diff, per_pixel = diff[pixels], per_pixel[pixels]
        assert (per_pixel <= 1e-3).mean() >= share, (per_pixel <= 1e-3).mean()
        assert diff.mean() < mean, diff.mean()

    for key in ("ldr", "hdr"):
        agree(t_out[key], j_out[key], 0.995, 1e-4)
    for f in ("accum_direct", "accum_albedo"):
        agree(getattr(t_state, f), getattr(j_state, f), 0.995, 1e-4)
    used = np.asarray(j_state.accum_albedo)[..., :3].max(-1) > 0.0
    assert used.mean() > 0.5
    agree(t_state.accum_irradiance, j_state.accum_irradiance, 0.995, 1e-4, used)
    agree(t_state.accum_irradiance, j_state.accum_irradiance, 0.89, 4e-3, ~used)
    assert float(t_out["ldr"].std()) > 0.01


# ------------------------------------------------------------------ the card


@pytest.mark.cuda
@pytest.mark.parametrize("nodes,compact", [(1, 0), (8, 32)])
def test_list_kernels_match_plain_versions_on_card(city_1600, nodes, compact):
    """K4, K5 and the walker (K6/K7) against their plain versions on
    city(1600)'s primary rays. On the card: chip_smoke.py phase 12 (K4
    and K5 on 65,536-ray subsets and the whole populations) and phase 13
    (the walker in every mode, P = 1, 8, 16, 32, 64 and 128, compact 0
    and 32, and on the MCPG guided rays under (True, 8, 32))."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    bundle = city_1600[0]
    acc = build_accel(bundle.scene, bundle.atlas, device=dev)
    o, d = (x.to(dev) for x in _city_primary(bundle, 128, 64))
    n = o.shape[0]
    rays, w, lo, hi = woop.k1_inputs(acc, o, d, torch.zeros(n, device=dev),
                                     torch.full((n,), 1e4, device=dev))
    torch.testing.assert_close(woop.target_keys(rays, acc.cluster_lo, acc.cluster_hi),
                               woop.target_keys_reference(rays, acc.cluster_lo, acc.cluster_hi),
                               rtol=0, atol=0)
    torch.testing.assert_close(woop.te_union(rays, lo, hi, slack=True),
                               woop.te_union_reference(rays, lo, hi, slack=True), rtol=0, atol=0)
    s = woop.TraceSchedule(node_clusters=nodes, compact=compact)
    before = woop.woop_list.launches
    t_k, tri_k = woop._walk(rays, w, lo, hi, s)
    assert woop.woop_list.launches == before + 1
    t_r, tri_r = woop.intersect_woop_reference(rays, w)
    torch.testing.assert_close(tri_k, tri_r, rtol=0, atol=0)
    torch.testing.assert_close(t_k, t_r, rtol=0, atol=0)
