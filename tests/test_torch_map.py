"""Map-scale tracing: K3 (streamed table) and K8 (dense sweep), port
against the JAX package, on the same inputs.

Scenes above ``RESIDENT_MAX_TRIS`` = 65,536 triangles go to K3;
``city(n_buildings=7000, seed=11)`` (70,400 triangles) is the CPU
stand-in for the bench's map scene ``city(28000, 11)``: it crosses the
threshold, so routing by size is tested without forcing it.

- K3's plain versions are K1's and K2's (a dense sweep): the port sent
  to K3 (its threshold set to 0) against the JAX streamed kernel in
  interpret mode
  and against the JAX partitioned sweep (``_sweep_parts``): ``tri`` equal
  and ``t`` within tests/test_accel.py's tolerance (rtol 1e-4, atol 1e-3:
  XLA fuses multiply-adds on the CPU and PyTorch does not); occlusion
  equal outside the t_max boundary band, as in tests/test_torch_accel.py.
- K3's schedule (per-warp node list from the least entries, near-to-far
  walk through nodes, sub-nodes and clusters, horizon exit with limits
  lagging by one tile, compacted visits, dead and occluded rays) is
  modelled in torch (tests/torch_walk_model.py) and must give exactly the
  plain versions' results; mutants of the model must not.
- K8's plain version (the port's CPU oracle arithmetic) on K8's table
  (``dense.mt_table``) against the JAX K8 in interpret mode: ``tri``
  equal, t/u/v within rtol 1e-5. K8's schedule (rays a thread, parts
  merged by key, tile order, the division-free pre-tests before the
  reciprocal, the resolve) is modelled in torch and must equal the
  oracle's body bit for bit; pre-test mutants that reject a +0
  numerator (a hit with u or v = -0) must not.
- One map-scale frame, PT and ReSTIR, at 32×18, port against the JAX
  package (both trace with the CPU oracle), with the bounds of
  tests/test_torch_slice.py and tests/test_torch_restir_slice.py (one
  set anew by their rule: see the ReSTIR test).

The CUDA kernels cannot run here; the ``cuda``-marked tests and
chip_smoke hold them against their plain versions on the card.
"""
import importlib
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.accel import build_accel as j_build_accel
from merian_quake_tpu.accel import woop as j_woop
from merian_quake_tpu.accel.pallas_intersect import intersect_packed as j_intersect_packed
from merian_quake_tpu.accel.pallas_intersect import pack_tris as j_pack_tris
from merian_quake_tpu.models.procedural import city as j_city
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.models.types import build_scene_from_soup as j_soup
from merian_quake_tpu.render.restir import ReSTIRConfig as JReSTIRConfig
from merian_quake_tpu.renderer import render_sequence as j_render_sequence
from merian_quake_tpu_torch.accel import build_accel, dense, intersect, woop
from merian_quake_tpu_torch.models.procedural import city
from merian_quake_tpu_torch.models.types import RenderConfig, build_scene_from_soup
from merian_quake_tpu_torch.render.restir import ReSTIRConfig
from merian_quake_tpu_torch.renderer import render_sequence
from torch_walk_model import NODE, _float_key, model_walk, sparse_warps, tie_table

# the module (the package's ``intersect`` attribute is the function)
intersect_mod = importlib.import_module("merian_quake_tpu_torch.accel.intersect")

# The suite runs several test processes side by side on a few cores;
# torch would start one thread per core in each and oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

T_RTOL, T_ATOL = 1e-4, 1e-3
MAP = dict(n_buildings=7000, seed=11)
MAP_TRIS = 70400


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


class _Spy:
    """Records which Woop wrappers a trace calls (on the CPU each runs
    its plain version, so the launch counters stay at 0)."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("woop_nearest", "woop_any", "woop_stream"):
            fn = getattr(woop, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                self.calls.append(_name + ("_any" if k.get("anyhit") else ""))
                return _fn(*a, **k)

            monkeypatch.setattr(woop, name, wrapped)


def _assert_same_hits(ours, ref):
    np.testing.assert_array_equal(_np(ours.tri), _np(ref.tri))
    hit = _np(ref.tri) >= 0
    np.testing.assert_allclose(_np(ours.t)[hit], _np(ref.t)[hit], rtol=T_RTOL, atol=T_ATOL)


def _clear_of_band(ta, o, d, t_max):
    """Rays whose nearest hit (oracle) is not within 1e-3·max(t_max, 1)
    of t_max: there the premultiplied any-hit test and the oracle's
    divided one may round to different sides."""
    ho = intersect(ta, torch.from_numpy(o), torch.from_numpy(d), 1e-3, torch.from_numpy(t_max))
    oh, tt = _np(ho.tri) >= 0, _np(ho.t)
    return ~oh | (np.abs(tt - t_max) > 1e-3 * np.maximum(t_max, 1.0))


# ------------------------------------------------------------------ K3 plain


def test_stream_plain_matches_jax_streamed_kernel(rng, monkeypatch):
    """Twin of test_accel.py:238: the JAX streamed kernel (interpret mode,
    ``resident=False``) against the port's K3 path (its threshold set to
    0), which runs K3's plain version on the CPU."""
    v0, v1, v2 = _soup(rng, 512)
    ja = j_build_accel(j_soup(v0, v1, v2))
    ta = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
    o, d = _rays(rng, 512)
    ref = j_woop.intersect_woop(ja, jnp.asarray(o), jnp.asarray(d), 0.0, 1e4,
                                ray_block=128, interpret=True, resident=False)
    monkeypatch.setattr(woop, "RESIDENT_MAX_TRIS", 0)
    spy = _Spy(monkeypatch)
    ours = woop.intersect_woop(ta, torch.from_numpy(o), torch.from_numpy(d), 0.0, 1e4)
    assert spy.calls == ["woop_stream"]
    _assert_same_hits(ours, ref)
    assert (_np(ours.tri) >= 0).any() and (_np(ours.tri) < 0).any()


def test_stream_plain_matches_jax_partitioned_sweep(rng, monkeypatch):
    """Twin of test_accel.py:271: the JAX partitioned resident sweep (4
    parts of 4 clusters) against the port's K3 path (its threshold set to
    0), for the nearest hit and for occlusion."""
    v0, v1, v2 = _soup(rng, 1024)
    ja = j_build_accel(j_soup(v0, v1, v2))
    ta = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
    o, d = _rays(rng, 256)
    t_max = rng.uniform(1.0, 200.0, 256).astype(np.float32)
    monkeypatch.setenv("MQ_PART_TRIS", "256")
    ref = j_woop.intersect_woop(ja, jnp.asarray(o), jnp.asarray(d), 0.0, 1e4,
                                ray_block=128, interpret=True)
    occ_ref = np.asarray(j_woop.intersect_woop_any(
        ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max), ray_block=128, interpret=True))
    monkeypatch.setattr(woop, "RESIDENT_MAX_TRIS", 0)
    spy = _Spy(monkeypatch)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    ours = woop.intersect_woop(ta, ot, dt, 0.0, 1e4)
    occ = _np(woop.intersect_woop_any(ta, ot, dt, 1e-3, torch.from_numpy(t_max)))
    assert spy.calls == ["woop_stream", "woop_stream_any"]  # no proxy below 4,096 triangles
    _assert_same_hits(ours, ref)
    clear = _clear_of_band(ta, o, d, t_max)
    np.testing.assert_array_equal(occ[clear], occ_ref[clear])
    assert clear.mean() > 0.95 and occ.any() and (~occ).any()
    assert (_np(ours.tri) >= 0).any() and (_np(ours.tri) < 0).any()


# ------------------------------------------------------------------ the map


@pytest.fixture(scope="module")
def map_scene():
    """city(7000, 11) in both packages; the port's on the CPU."""
    jb = j_city(**MAP)
    tb = city(**MAP, device="cpu")
    return jb, j_build_accel(jb.scene, jb.atlas), tb, build_accel(tb.scene, tb.atlas)


def test_map_tables_match_jax_and_route_to_stream(map_scene, monkeypatch):
    jb, ja, tb, ta = map_scene
    assert ta.scene.num_tris == MAP_TRIS > woop.RESIDENT_MAX_TRIS
    for f in ("v0", "v1", "v2", "texnum", "flags", "valid"):
        np.testing.assert_array_equal(_np(getattr(ta.scene, f)), np.asarray(getattr(ja.scene, f)))
    np.testing.assert_array_equal(_np(ta.candidate), np.asarray(ja.candidate))
    np.testing.assert_array_equal(_np(ta.cluster_lo), np.asarray(ja.cluster_lo))
    np.testing.assert_array_equal(_np(ta.cluster_hi), np.asarray(ja.cluster_hi))
    jw = np.asarray(ja.woop_w)
    np.testing.assert_allclose(_np(ta.woop_w), jw, rtol=1e-6, atol=1e-6 * np.abs(jw).max())
    jp = np.asarray(ja.woop_w_proxy)
    np.testing.assert_allclose(_np(ta.woop_w_proxy), jp, rtol=1e-6, atol=1e-6 * np.abs(jp).max())
    np.testing.assert_array_equal(_np(ta.cluster_lo_proxy), np.asarray(ja.cluster_lo_proxy))
    assert ta.woop_w_proxy.shape[0] // 3 == 4096

    # routing by size, with no argument: the map's sweeps go to K3 (the
    # proxy pre-pass over its 4,096-triangle table is not run: PERF.md,
    # section 6); with the threshold above the map's size, K1 gives the same hits
    u = tb.uniforms
    o = u.cam_x.expand(128, 3).contiguous()
    d = torch.nn.functional.normalize(u.cam_w + torch.linspace(-0.3, 0.3, 128)[:, None]
                                      * u.cam_u.roll(1), dim=-1)
    spy = _Spy(monkeypatch)
    hr = woop.intersect_woop(ta, o, d, 0.0, 1e4)
    occ = woop.intersect_woop_any(ta, o, d, 1e-3, 500.0)
    monkeypatch.setattr(woop, "RESIDENT_MAX_TRIS", MAP_TRIS)
    forced = woop.intersect_woop(ta, o, d, 0.0, 1e4)
    assert spy.calls == ["woop_stream", "woop_stream_any", "woop_nearest"]
    assert bool(hr.hit.all()) and bool(occ.any())
    for a, b in zip(hr, forced):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # intersect() on CPU tensors is the oracle (Möller–Trumbore): the same
    # hits but for a ray split by an edge both tests round differently
    ho = intersect(ta, o, d, 0.0, 1e4)
    assert (_np(ho.tri) == _np(hr.tri)).mean() >= 0.99
    np.testing.assert_allclose(_np(ho.t), _np(hr.t), rtol=T_RTOL, atol=T_ATOL)


# ------------------------------------------------------------------ K3 schedule


def _model_k3(rays, w, lo, hi, anyhit=False, occluded_in=None, mutant=None):
    """torch model of csrc/woop_stream.cu's schedule (the walk of
    csrc/woop_walk.cuh along each warp's node list,
    tests/torch_walk_model.py), a warp of 32 rays at a time:
    1. node list: per node the least slab entry over the lanes that reach
       its box within slack(t_max) (occluded rays take no part), empty
       boxes never listed, ordered by the kernel's key (te bits >> 13,
       node id);
    2. walk: stop at the first node whose rounded-down te exceeds the
       horizon (the largest gate limit over the warp, refreshed once a
       node); gate the node again with the current limits, then its
       sub-nodes and their member clusters;
    3. ring: a reached cluster is fetched at once and the tile fetched
       before it tested only then, so the limits a gate sees lag by one
       tile; at test time each lane gates again with its current limit; a
       tile few lanes reach is tested triangle per lane.
    Returns the nearest (t, tri) or the occlusion, like the plain
    versions."""
    return model_walk(rays, w, lo, hi, NODE, listed=True, anyhit=anyhit,
                      occluded_in=occluded_in, mutant=mutant)


def _city_primary(bundle, width, height):
    from merian_quake_tpu_torch.ops import camera
    from merian_quake_tpu_torch.render import layout

    u = bundle.uniforms
    px, py = layout.gen_pixels(width, height, device="cpu")
    d = camera.ray_dir(px.float(), py.float(), width, height, u.cam_u, u.cam_w, u.fov_tan_half)
    return u.cam_x.expand_as(d).contiguous(), d


def _bounce(bundle, accel, width, height):
    """The path tracer's first bounce at frame 0, sorted as the frame
    sorts it; dead rays (t_max = -1) go to trailing blocks."""
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
    o, d, t_max = cur.pos - cur.wi * 1e-3, wo, torch.where(live, 1e4, -1.0)
    perm = woop.sort_perm(accel, o, d, t_max)
    return o[perm].contiguous(), d[perm].contiguous(), t_max[perm].contiguous(), cur.pos


def _population(name, rng, map_scene):
    """(accel, o, d, t_min, t_max) of one test population. ``*_sparse``:
    one or two live rays a warp (every tile visit is compacted)."""
    if name.endswith("_sparse"):
        acc, o, d, t_min, t_max = _population(name[: -len("_sparse")], rng, map_scene)
        return acc, o, d, t_min, sparse_warps(t_max)
    if name == "soup":
        v0, v1, v2 = _soup(rng, 512)
        acc = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
        o, d = (torch.from_numpy(x) for x in _rays(rng, 512, misses=True))
        return acc, o, d, 0.0, torch.from_numpy(rng.uniform(1.0, 200.0, 512).astype(np.float32))
    scene, kind = name.split("_")
    if scene == "map":
        bundle, acc = map_scene[2], map_scene[3]
    else:
        bundle = city(device="cpu")
        acc = build_accel(bundle.scene, bundle.atlas)
    if kind == "primary":
        o, d = _city_primary(bundle, 32, 16)
        return acc, o, d, 0.0, torch.full((o.shape[0],), 1e4)
    o, d, t_max, pos = _bounce(bundle, acc, 32, 16)
    if kind == "bounce":
        return acc, o, d, 1e-3, t_max
    # shadow: gbuffer points to random points in the scene's bounds
    g = torch.Generator().manual_seed(5)
    to = acc.world_lo + (acc.world_hi - acc.world_lo) * torch.rand(pos.shape, generator=g)
    wo = to - pos
    dist = torch.linalg.vector_norm(wo, dim=-1)
    return acc, pos, wo / dist[:, None], 1e-3, torch.clamp_min(dist - 2e-3, 1e-3)


def _k3_inputs(name, rng, map_scene):
    """(n, nearest-hit args, (rays, proxy, shadow)) of one population;
    ``ties``: the hand-laid table with duplicated triangles (no accel: its
    rays come packed, and it has neither proxy nor shadow table)."""
    if name == "ties":
        args = tie_table("cpu")
        return args[0].shape[1], args, (args[0], None, args[1:])
    acc, o, d, t_min, t_max = _population(name, rng, map_scene)
    n = o.shape[0]
    t_min = torch.full((n,), t_min) if isinstance(t_min, float) else t_min
    return n, woop.k1_inputs(acc, o, d, t_min, t_max), woop.k2_inputs(acc, o, d, t_min, t_max)


@pytest.mark.parametrize("name,anyhit", [
    ("soup", False), ("soup", True), ("city_primary", False), ("city_bounce", False),
    ("city_shadow", True), ("map_primary", False), ("map_bounce", False),
    ("map_bounce", True), ("map_shadow", True), ("map_primary_sparse", False),
    ("map_shadow_sparse", True), ("ties", False), ("ties", True),
])
def test_k3_schedule_matches_plain_version(rng, map_scene, name, anyhit):
    n, args, (rays, proxy, shadow) = _k3_inputs(name, rng, map_scene)
    if not anyhit:
        t_ref, tri_ref = woop.intersect_woop_reference(args[0], args[1])
        t_mod, tri_mod = _model_k3(*args)
        assert (tri_ref >= 0).any()
        if name == "soup":
            assert (tri_ref[:n] < 0).any()
        torch.testing.assert_close(tri_mod, tri_ref, rtol=0, atol=0)
        torch.testing.assert_close(t_mod, t_ref, rtol=0, atol=0)
        t_w, tri_w = woop.woop_stream(*args)  # the CPU wrapper is the plain version
        torch.testing.assert_close(tri_w, tri_ref, rtol=0, atol=0)
        return
    dense_occ = woop.intersect_woop_any_reference(rays, shadow[0])
    assert dense_occ[:n].any() and (~dense_occ[:n]).any()
    torch.testing.assert_close(_model_k3(rays, *shadow, anyhit=True), dense_occ, rtol=0, atol=0)
    if proxy is not None:  # warm start from the proxy pre-pass
        pre = woop.intersect_woop_any_reference(rays, proxy[0])
        assert pre[:n].any()
        torch.testing.assert_close(_model_k3(rays, *shadow, anyhit=True, occluded_in=pre),
                                   dense_occ, rtol=0, atol=0)
        torch.testing.assert_close(woop.woop_stream(rays, *shadow, anyhit=True, occluded_in=pre),
                                   dense_occ, rtol=0, atol=0)


@pytest.mark.parametrize("mutant,name,anyhit", [
    ("early_exit", "map_primary", False), ("early_exit", "city_shadow", True),
    ("compact_drops_last", "map_primary_sparse", False),
    ("compact_drops_last", "map_shadow_sparse", True),
    ("winner_ignores_index", "ties", False),
])
def test_k3_schedule_mutants_fail(rng, map_scene, mutant, name, anyhit):
    """Each mutant of the walk gives another result than the plain
    version: an exit one node early, a compacted visit that leaves out its
    last reaching ray, a compacted winner that takes the highest index
    among equal t."""
    n, args, (rays, proxy, shadow) = _k3_inputs(name, rng, map_scene)
    if anyhit:
        ref = woop.intersect_woop_any_reference(rays, shadow[0])
        out = _model_k3(rays, *shadow, anyhit=True, mutant=mutant)
    else:
        ref = woop.intersect_woop_reference(args[0], args[1])[1]
        out = _model_k3(*args, mutant=mutant)[1]
    assert int((out != ref).sum()) > 0


def test_woop_stream_rejects_bad_inputs(rng):
    v0, v1, v2 = _soup(rng, 64)
    acc = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
    o, d = (torch.from_numpy(x) for x in _rays(rng, 256))
    rays, w, lo, hi = woop.k1_inputs(acc, o, d, torch.zeros(256), torch.full((256,), 1e4))
    good = torch.zeros(256, dtype=torch.bool)
    for args, kw in (
        ((rays.double(), w, lo, hi), {}),  # dtype
        ((rays[:, :200], w, lo, hi), {}),  # shape / block split
        ((rays, w, lo.double(), hi), {}),  # bounds
        ((rays, w, lo, hi), {"occluded_in": good}),  # a warm start needs anyhit
        ((rays, w, lo, hi), {"anyhit": True, "occluded_in": good[:128]}),
        ((rays, w, lo, hi), {"counts": torch.zeros(2, dtype=torch.int64)}),  # the CPU counts nothing
    ):
        with pytest.raises(ValueError):
            woop.woop_stream(*args, **kw)
    # above its largest cluster count it raises (nothing falls back)
    lo_big = torch.zeros((woop.MAX_STREAM_CLUSTERS + 1, 3))
    with pytest.raises(ValueError, match="clusters"):
        woop.woop_stream(rays, w, lo_big, lo_big)


# ------------------------------------------------------------------ K8


@pytest.mark.parametrize("scene", ["soup", "city"])
def test_k8_plain_matches_jax_packed_kernel(rng, scene):
    """The port's K8 plain version (the oracle's arithmetic) on K8's table
    (``dense.mt_table``: v0, the rounded edges and the flag, made from the
    JAX package's packed layout) against the JAX K8
    (pallas_intersect.intersect_packed) in interpret mode."""
    if scene == "soup":
        v0, v1, v2 = _soup(rng, 256, spread=8.0)
        ja = j_build_accel(j_soup(v0, v1, v2))
        ta = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
        o, d = (torch.from_numpy(x) for x in _rays(rng, 512, misses=True))
    else:
        jb, tb = j_city(), city(device="cpu")
        ja, ta = j_build_accel(jb.scene, jb.atlas), build_accel(tb.scene, tb.atlas)
        o, d = _city_primary(tb, 32, 16)
    n = o.shape[0]
    rays = woop._pack_rays(o, d, torch.zeros(n), torch.full((n,), 1e4), woop.RAY_BLOCK)
    tris = dense.pack_tris(ta.scene.v0, ta.scene.v1, ta.scene.v2, ta.candidate)
    j_tris = np.asarray(j_pack_tris(ja.scene.v0, ja.scene.v1, ja.scene.v2, ja.candidate))
    np.testing.assert_array_equal(_np(tris), j_tris)
    # K8's table: (v0, flag), (e1, 0), (e2, 0) a triangle, the edges rounded
    table = dense.mt_table(tris)
    assert table.shape == (j_tris.shape[1], 12) and table.is_contiguous()
    zero = np.zeros((j_tris.shape[1], 1), np.float32)
    np.testing.assert_array_equal(_np(table), np.concatenate(
        [j_tris[0:3].T, j_tris[9:10].T, (j_tris[3:6] - j_tris[0:3]).T, zero,
         (j_tris[6:9] - j_tris[0:3]).T, zero], axis=1))
    np.testing.assert_array_equal(_np(dense.scene_table(ta)), _np(table))
    out, idx = j_intersect_packed(jnp.asarray(_np(rays)), jnp.asarray(j_tris), ray_block=n,
                                  interpret=True)
    out, idx = np.asarray(out), np.asarray(idx)[0]
    t, tri, u, v = dense.mt_dense(rays, table)  # the CPU wrapper is the plain version
    np.testing.assert_array_equal(_np(tri), idx)
    hit = idx >= 0
    assert hit.any() and (scene == "city" or (~hit).any())
    np.testing.assert_array_equal(_np(t)[~hit], out[0][~hit])
    for ours, ref in ((t, out[0]), (u, out[1]), (v, out[2])):
        np.testing.assert_allclose(_np(ours)[hit], ref[hit], rtol=1e-5, atol=1e-6)
    # intersect_dense is the oracle on CPU tensors: the same hit record
    hr = dense.intersect_dense(ta, o, d, 0.0, 1e4)
    for a, b in zip(hr, intersect(ta, o, d, 0.0, 1e4)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mt_dense_rejects_bad_inputs(rng):
    v0, v1, v2 = _soup(rng, 64)
    acc = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
    o, d = (torch.from_numpy(x) for x in _rays(rng, 256))
    rays = woop._pack_rays(o, d, torch.zeros(256), torch.full((256,), 1e4), woop.RAY_BLOCK)
    table = dense.scene_table(acc)
    for bad in ((rays[:, :200], table), (rays, table[:32].contiguous()), (rays.double(), table),
                (rays, table[:, :10].contiguous()), (rays, table.T.contiguous())):
        with pytest.raises(ValueError):
            dense.mt_dense(*bad)
    with pytest.raises(ValueError):  # the CPU counts nothing
        dense.mt_dense(rays, table, counts=torch.zeros((2, 3), dtype=torch.int64))


# K8's schedule constants, read from the source so that the model keeps
# the rays a thread, the tile and the pre-test threshold the kernel has
with open(os.path.join(os.path.dirname(dense.__file__), "..", "csrc", "mt_dense.cu")) as _f:
    _K8_SRC = _f.read()
K8_THREADS, K8_RAYS, K8_TRIS = (int(re.search(rf"constexpr int {k} = (\d+);", _K8_SRC).group(1))
                                for k in ("kThreads", "kRays", "kTris"))
K8_TINY = float.fromhex(re.search(r"constexpr float kTiny = (0x[0-9a-fp.+-]+)f;", _K8_SRC).group(1))


def _model_k8(rays, table, parts, mutant=None):
    """torch model of csrc/mt_dense.cu's schedule: a CTA of K8_THREADS
    threads holds K8_RAYS rays a thread (ray CTA base + r * K8_THREADS +
    thread), a warp's vote covers its 32 threads' rays; the tiles of
    K8_TRIS triangles are split into ``parts`` runs (the grid's second
    dimension), each swept in tile order with a running best (t, tri) and a
    strict <; per pair the pre-test levels of the kernel, each skipped by a
    warp when no pair of it passed the level before: (1) p, det: front and
    the flag; (2) s, s . p: s . p < K8_TINY or det = -inf; (3) q, d . q,
    e2 . q: d . q < K8_TINY or det = -inf, and e2 . q < 0 where t_min >= 0;
    then the reciprocal and the exact test; the parts merge by the least
    (order-preserving key of t, tri); the winner's t, u, v are recomputed.
    Mutants of the pre-test: ``rejects_zero_u`` / ``rejects_zero_v`` (level
    2 / 3 asks s . p < 0 / d . q < 0, so a +0 numerator, whose u or v is
    -0 and passes >= 0, is rejected). Returns (t, tri, u, v)."""
    n = rays.shape[1]
    ntiles = table.shape[0] // K8_TRIS
    per = -(-ntiles // parts)
    cta = K8_THREADS * K8_RAYS
    n_cta = -(-n // cta)
    # ray index of (CTA, slot r, warp, lane), regrouped a warp's rays a row
    idx = torch.arange(n_cta * cta).reshape(n_cta, K8_RAYS, K8_THREADS // 32, 32)
    order = idx.permute(0, 2, 1, 3).reshape(-1, 32 * K8_RAYS)
    live = order < n
    src = torch.where(live, order, 0)
    # per warp and ray slot, broadcast against the triangles of a chunk;
    # past n a ray has d = 0 (no pair is front-facing)
    ox, oy, oz, dx, dy, dz, t0, t1 = (torch.where(live, rays[k][src], 0.0)[..., None]
                                      for k in range(8))
    none = (1 << 63) - 1
    keys = torch.full(order.shape, none, dtype=torch.int64)

    def cross1(ay, az, by, bz):
        return ay * bz - az * by

    def dot3(ax, ay, az, bx, by, bz):
        return ax * bx + ay * by + az * bz

    chunk = 16  # tiles at a time: the running best's update is the same
    for p in range(-(-ntiles // per)):
        best = torch.full(order.shape, woop.BIG)
        best_tri = torch.full(order.shape, -1, dtype=torch.int64)
        for j0 in range(p * per, min(ntiles, (p + 1) * per), chunk):
            j1 = min(j0 + chunk, ntiles, (p + 1) * per)
            tri = table[j0 * K8_TRIS:j1 * K8_TRIS]
            a, e1, e2 = tri[:, 0:4].T, tri[:, 4:7].T, tri[:, 8:11].T  # (4 | 3, C)
            px = cross1(dy, dz, e2[1], e2[2])
            py = cross1(dz, dx, e2[2], e2[0])
            pz = cross1(dx, dy, e2[0], e2[1])
            det = dot3(e1[0], e1[1], e1[2], px, py, pz)
            f = (det < -dense.DET_EPS) & (a[3] > 0.5)
            inf_det = det == -torch.inf
            f &= f.any(1, keepdim=True)  # a warp's vote a triangle
            sx, sy, sz = ox - a[0], oy - a[1], oz - a[2]
            un = dot3(sx, sy, sz, px, py, pz)
            f &= (un < (0.0 if mutant == "rejects_zero_u" else K8_TINY)) | inf_det
            f &= f.any(1, keepdim=True)
            qx = cross1(sy, sz, e1[1], e1[2])
            qy = cross1(sz, sx, e1[2], e1[0])
            qz = cross1(sx, sy, e1[0], e1[1])
            vn = dot3(dx, dy, dz, qx, qy, qz)
            tn = dot3(e2[0], e2[1], e2[2], qx, qy, qz)
            f &= (vn < (0.0 if mutant == "rejects_zero_v" else K8_TINY)) | inf_det
            f &= (tn < 0.0) | ~(t0 >= 0.0)
            f &= f.any(1, keepdim=True)
            inv = torch.reciprocal(torch.where(f, det, -1.0))
            u, v, t = un * inv, vn * inv, tn * inv
            ok = f & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t0) & (t <= t1)
            # triangles in index order with a strict <: the first least t wins
            t_m = torch.where(ok, t, woop.BIG)
            k = torch.argmin(t_m, dim=-1)
            tk = torch.gather(t_m, -1, k[..., None])[..., 0]
            better = tk < best
            best = torch.where(better, tk, best)
            best_tri = torch.where(better, j0 * K8_TRIS + k, best_tri)
        key = (_float_key(best) << 31) | best_tri
        keys = torch.where(best_tri >= 0, torch.minimum(keys, key), keys)
    # back to ray order; each winner's t, u, v recomputed
    flat = torch.full((n_cta * cta,), none, dtype=torch.int64)
    flat[order.reshape(-1)] = keys.reshape(-1)
    flat = flat[:n]
    hit = flat != none
    tri = torch.where(hit, flat & ((1 << 31) - 1), 0)
    a, e1, e2 = table[tri, 0:3].T, table[tri, 4:7].T, table[tri, 8:11].T
    o, d = rays[0:3], rays[3:6]
    px = cross1(d[1], d[2], e2[1], e2[2])
    py = cross1(d[2], d[0], e2[2], e2[0])
    pz = cross1(d[0], d[1], e2[0], e2[1])
    inv = torch.reciprocal(dot3(e1[0], e1[1], e1[2], px, py, pz))
    sx, sy, sz = o[0] - a[0], o[1] - a[1], o[2] - a[2]
    qx = cross1(sy, sz, e1[1], e1[2])
    qy = cross1(sz, sx, e1[2], e1[0])
    qz = cross1(sx, sy, e1[0], e1[1])
    t = dot3(e2[0], e2[1], e2[2], qx, qy, qz) * inv
    u = dot3(sx, sy, sz, px, py, pz) * inv
    v = dot3(d[0], d[1], d[2], qx, qy, qz) * inv
    return (torch.where(hit, t, woop.BIG), torch.where(hit, tri, -1).to(torch.int32),
            torch.where(hit, u, 0.0), torch.where(hit, v, 0.0))


def _edge_grid():
    """A hand-laid floor of unit squares (z = 0, each two triangles facing
    +z, corners on integers) and rays straight down from z = 1 at every
    quarter point: exact arithmetic, so rays on an edge meet s . p = +0 or
    d . q = +0, whose u or v is -0 (a hit), and two triangles tie on a
    shared edge. (rays f32[8, n], table)."""
    tri = []
    for x in range(8):
        for y in range(4):
            tri.append([(x, y, 0), (x, y + 1, 0), (x + 1, y, 0)])
            tri.append([(x + 1, y + 1, 0), (x + 1, y, 0), (x, y + 1, 0)])
    tri = torch.tensor(tri, dtype=torch.float32)
    tris = dense.pack_tris(tri[:, 0], tri[:, 1], tri[:, 2], torch.ones(len(tri), dtype=torch.bool))
    q = torch.arange(0, 8.25, 0.25)
    gx, gy = torch.meshgrid(q, q[q <= 4.0], indexing="ij")
    n = gx.numel()
    o = torch.stack([gx.reshape(-1), gy.reshape(-1), torch.ones(n)], 1)
    d = torch.tensor([0.0, 0.0, -1.0]).expand(n, 3)
    rays = woop._pack_rays(o, d, torch.zeros(n), torch.full((n,), 1e4), woop.RAY_BLOCK)
    return rays, dense.mt_table(tris)


def _k8_population(rng, map_scene, name):
    """(rays, table, parts, the oracle's (t, tri, u, v)) of one K8 test
    population: the oracle's body ``dense.mt_nearest`` on the scene's
    vertices, or on the edge grid its body on K8's table."""
    if name == "edges":
        rays, table = _edge_grid()
        return rays, table, 2, dense.intersect_dense_reference(rays, table)
    if name == "soup":
        v0, v1, v2 = _soup(rng, 256, spread=8.0)
        acc = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
        o, d = (torch.from_numpy(x) for x in _rays(rng, 512, misses=True))
        t_min, parts = torch.zeros(512), 3
    else:  # a subset of the map's primary rays, t_min 1e-3
        acc = map_scene[3]
        o, d = _city_primary(map_scene[2], 16, 16)
        t_min, parts = torch.full((256,), 1e-3), 5
    n = o.shape[0]
    t_max = torch.full((n,), 1e4)
    rays = woop._pack_rays(o, d, t_min, t_max, woop.RAY_BLOCK)
    s = acc.scene
    ref = dense.mt_nearest(o, d, t_min, t_max, s.v0, s.v1, s.v2, acc.candidate)
    return rays, dense.scene_table(acc), parts, ref


@pytest.mark.parametrize("name", ["soup", "map", "edges"])
def test_k8_schedule_matches_oracle(rng, map_scene, name):
    """The torch model of K8's schedule (rays a thread, parts, tile order,
    the division-free pre-tests before the reciprocal, the keyed merge and
    the resolve) equals the oracle's body bit for bit in (t, tri, u, v)."""
    rays, table, parts, ref = _k8_population(rng, map_scene, name)
    n = ref[0].shape[0]
    out = _model_k8(rays, table, parts)
    assert (ref[1] >= 0).any() and (name == "map" or (ref[1] < 0).any())
    if name == "edges":  # hits with u = -0 and with v = -0
        hit = ref[1] >= 0
        for x in (ref[2], ref[3]):
            assert ((x == 0) & torch.signbit(x) & hit).any()
    for a, b in zip(out, ref):
        a = a[:n]
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), int((a != b).sum())
    # the CPU wrapper is the plain version
    for a, b in zip(dense.mt_dense(rays, table), ref):
        assert torch.equal(a[:n].view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("mutant", ["rejects_zero_u", "rejects_zero_v"])
def test_k8_pretest_mutants_fail(rng, map_scene, mutant):
    """A pre-test that rejects a +0 numerator (so a hit with u or v = -0,
    which passes u >= 0, is lost) gives another nearest hit than the
    oracle on the edge grid."""
    rays, table, parts, ref = _k8_population(rng, map_scene, "edges")
    out = _model_k8(rays, table, parts, mutant=mutant)
    assert int((out[1] != ref[1]).sum()) > 0


# ------------------------------------------------------------------ frames


W, H = 32, 18


def _agree(ours, ref, share, mean, pixels=None):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    diff = np.abs(ours - ref)
    per_pixel = diff.max(-1) if diff.ndim == 3 else diff
    if pixels is not None:
        diff, per_pixel = diff[pixels], per_pixel[pixels]
    assert (per_pixel <= 1e-3).mean() >= share, (per_pixel <= 1e-3).mean()
    assert diff.mean() < mean, diff.mean()


def test_map_pt_frame_matches_jax():
    """One 32×18 path-traced frame (2 spp, max path length 3) of the map
    scene, with tests/test_torch_slice.py's bounds."""
    cfg = dict(width=W, height=H, spp=2, max_path_length=3)
    j_state, j_out = j_render_sequence(j_city(**MAP), JConfig(**cfg), frames=1)
    jax.block_until_ready(j_out["ldr"])
    t_state, t_out = render_sequence(city(**MAP, device="cpu"), RenderConfig(**cfg), frames=1,
                                     device="cpu")
    for key in ("ldr", "hdr"):
        _agree(t_out[key], j_out[key], 0.995, 1e-4)
    for f in ("accum_direct", "accum_albedo"):
        _agree(getattr(t_state, f), getattr(j_state, f), 0.995, 1e-4)
    used = np.asarray(j_state.accum_albedo)[..., :3].max(-1) > 0.0
    assert used.mean() > 0.5
    _agree(t_state.accum_irradiance, j_state.accum_irradiance, 0.995, 1e-4, used)
    _agree(t_state.accum_irradiance, j_state.accum_irradiance, 0.89, 4e-3, ~used)
    assert float(t_out["ldr"].std()) > 0.01


def test_map_restir_frame_matches_jax():
    """One 32×18 ReSTIR frame (``ReSTIRConfig()``) of the map scene, with
    tests/test_torch_restir_slice.py's bounds but one, set by that file's
    rule (the JAX package's jitted run against its op-by-op run, 1.25× its
    mean): on the 215 pixels whose irradiance the image never uses, two
    pixels' raw path radiance differs in the JAX package itself, 99.07%
    within 1e-3 and mean |Δ| 3.614e-3 (the port reads the same against
    the jitted run), so the mean there is held below 4.52e-3. Every other
    reading is 100% within 1e-3 on both sides."""
    cfg = dict(width=W, height=H, integrator="restir")
    j_state, j_out = j_render_sequence(j_city(**MAP), JConfig(**cfg), frames=1,
                                       mcpg_config=JReSTIRConfig())
    jax.block_until_ready(j_out["ldr"])
    t_state, t_out = render_sequence(city(**MAP, device="cpu"), RenderConfig(**cfg), frames=1,
                                     mcpg_config=ReSTIRConfig(), device="cpu")
    for key in ("ldr", "hdr"):
        _agree(t_out[key], j_out[key], 0.996, 2.2e-5)
    used = np.asarray(j_state.accum_albedo)[..., :3].max(-1) > 0.0
    assert used.mean() > 0.5
    _agree(t_state.accum_irradiance, j_state.accum_irradiance, 0.995, 1.45e-4, used)
    _agree(t_state.accum_irradiance, j_state.accum_irradiance, 0.955, 4.52e-3, ~used)
    for f in ("accum_direct", "accum_albedo"):
        _agree(getattr(t_state, f), getattr(j_state, f), 0.999, 1e-6)
    res, j_res = t_state.restir.reservoirs, j_state.restir.reservoirs
    np.testing.assert_array_equal(res.M.numpy(), np.asarray(j_res.M))
    w, j_w = res.w.numpy(), np.asarray(j_res.w)
    assert (np.abs(w - j_w) <= 1e-4 * np.maximum(np.abs(j_w), 1e-30)).mean() >= 0.983


# ------------------------------------------------------------------ the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("anyhit", [False, True])
def test_k3_kernel_matches_plain_version_on_card(map_scene, anyhit):
    """K3 against its plain versions on the map's primary rays, nearest
    and any-hit on the whole table. On the card: chip_smoke phase 8
    ("map primary 65536 ... K3 vs plain" and "map primary 65536
    t_min=0.001 K3 any-hit vs plain")."""
    dev = _card()
    tb = map_scene[2]
    acc = build_accel(tb.scene, tb.atlas, device=dev)
    o, d = _city_primary(tb, 128, 64)
    n = o.shape[0]
    args = woop.k1_inputs(acc, o.to(dev), d.to(dev), torch.full((n,), 1e-3, device=dev),
                          torch.full((n,), 1e4, device=dev))
    before = woop.woop_stream.launches
    if anyhit:
        occ = woop.woop_stream(*args, anyhit=True)
        torch.testing.assert_close(occ, woop.intersect_woop_any_reference(args[0], args[1]),
                                   rtol=0, atol=0)
    else:
        t_k, tri_k = woop.woop_stream(*args)
        t_r, tri_r = woop.intersect_woop_reference(args[0], args[1])
        torch.testing.assert_close(tri_k, tri_r, rtol=0, atol=0)
        torch.testing.assert_close(t_k, t_r, rtol=0, atol=0)
    assert woop.woop_stream.launches == before + 1


@pytest.mark.cuda
def test_k8_kernel_matches_oracle_on_card(map_scene):
    """K8 through ``intersect_dense`` against the oracle on the map's
    primary rays. On the card: chip_smoke phase 9 (the random soup
    and a 65,536-ray map subset)."""
    dev = _card()
    tb = map_scene[2]
    acc = build_accel(tb.scene, tb.atlas, device=dev)
    o, d = _city_primary(tb, 64, 32)
    o, d = o.to(dev), d.to(dev)
    before = dense.mt_dense.launches
    hr = dense.intersect_dense(acc, o, d, 0.0, 1e4)
    assert dense.mt_dense.launches == before + 1
    ref = intersect_mod._intersect_oracle(acc, o, d, 0.0, 1e4)
    for a, b in zip(hr, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
