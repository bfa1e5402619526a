"""The port's accel layer against the JAX package's, on the same inputs.

Tables: the triangle order, ``candidate`` and ``needs_alpha`` are equal;
the Woop rows, cluster bounds and shading attributes agree to f32
rounding (rtol 1e-6; the JAX build inverts each triangle's 3×3 matrix
in C++, the port with numpy's LAPACK, and both round the float64 result
to f32). Hits: triangle ids are equal wherever the nearest t is unique,
and t agrees as in tests/test_accel.py (rtol 1e-4, atol 1e-3): XLA fuses
multiply-adds on the CPU and PyTorch does not.

The CUDA kernels cannot run here; their traversal schedules (K1: the
walk of csrc/woop_walk.cuh in node order; K2: its any-hit instance, in
the order csrc/woop_any.cu launches, with occluded lanes dropping out, a
warm start and the walk's end once every lane is occluded; both modelled
in tests/torch_walk_model.py) are modelled in torch and must give exactly
the dense plain versions' results, and mutants of the models must not.
The kernels are compared with the plain versions on the card by the
``cuda``-marked tests and by chip_smoke.py.

Any-hit (K2): the shadow, alpha-only and proxy tables are built as the
JAX package builds them (zero-row masks and AABBs exact, rows to
rtol 1e-6). The plain K2 agrees with the JAX kernel in interpret mode
and with the oracle's occlusion on every ray except those whose nearest
hit lies within 1e-3·max(t_max, 1) of t_max, as in tests/test_accel.py
(the any-hit test is premultiplied by dz; the oracle divides).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.accel import build_accel as j_build_accel
from merian_quake_tpu.accel import intersect as j_intersect
from merian_quake_tpu.accel import trace_nearest as j_trace_nearest
from merian_quake_tpu.accel.intersect import trace_visibility as j_trace_visibility
from merian_quake_tpu.accel import woop as j_woop
from merian_quake_tpu.models import materials
from merian_quake_tpu.models import procedural as j_procedural
from merian_quake_tpu.models.types import build_scene_from_soup as j_soup
from merian_quake_tpu_torch import interop
from merian_quake_tpu_torch.accel import build_accel, intersect, trace_nearest, woop
from merian_quake_tpu_torch.accel.intersect import trace_visibility
from merian_quake_tpu_torch.models import procedural
from merian_quake_tpu_torch.models.types import build_scene_from_soup
from torch_walk_model import K2_LISTED, NODE, model_walk, sparse_warps, tie_table

# the module (the package's ``intersect`` attribute is the function)
intersect_mod = importlib.import_module("merian_quake_tpu_torch.accel.intersect")

# The suite runs several test processes side by side on a few cores;
# torch would start one thread per core in each and oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

T_RTOL, T_ATOL = 1e-4, 1e-3


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _random_soup(rng, n_tri=256, spread=8.0):
    c = rng.uniform(-40, 40, (n_tri, 1, 3))
    tri = (c + rng.uniform(-spread, spread, (n_tri, 3, 3))).astype(np.float32)
    return tri[:, 0], tri[:, 1], tri[:, 2]


def _soup_rays(rng, n=512):
    """test_accel.py's rays: half of them aimed away from the soup."""
    o = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[: n // 2] = 500.0
    d[: n // 2] = np.abs(d[: n // 2])
    return o, d


def _city_primary(bundle, width=64, height=64):
    from merian_quake_tpu_torch.ops import camera
    from merian_quake_tpu_torch.render import layout

    u = bundle.uniforms
    px, py = layout.gen_pixels(width, height, device="cpu")
    d = camera.ray_dir(px.float(), py.float(), width, height, u.cam_u, u.cam_w, u.fov_tan_half)
    return u.cam_x.expand_as(d).contiguous(), d


def _assert_hits_match(ours, ref):
    """tri equal where t is unique; t within test_accel's tolerance."""
    o_tri, r_tri = _np(ours.tri), _np(ref.tri)
    o_t, r_t = _np(ours.t), _np(ref.t)
    np.testing.assert_array_equal(o_tri >= 0, r_tri >= 0)
    hit = r_tri >= 0
    np.testing.assert_allclose(o_t[hit], r_t[hit], rtol=T_RTOL, atol=T_ATOL)
    differ = o_tri != r_tri
    # a differing id must be an exact-tie: same t (shared edge / coplanar)
    np.testing.assert_allclose(o_t[differ], r_t[differ], rtol=T_RTOL, atol=T_ATOL)
    assert differ.mean() <= 1e-3, differ.mean()


# ------------------------------------------------------------------ tables


@pytest.mark.parametrize("name", ["box", "city"])
def test_build_accel_tables_match_jax(name):
    jb = j_procedural.get_scene(name)
    tb = procedural.get_scene(name, device="cpu")
    ja = j_build_accel(jb.scene, jb.atlas)
    ta = build_accel(tb.scene, tb.atlas)
    # same procedural soup and the same median-split order
    for f in ("v0", "v1", "v2", "st", "texnum", "flags", "valid"):
        np.testing.assert_array_equal(_np(getattr(ta.scene, f)), np.asarray(getattr(ja.scene, f)))
    np.testing.assert_array_equal(_np(ta.candidate), np.asarray(ja.candidate))
    np.testing.assert_array_equal(_np(ta.needs_alpha), np.asarray(ja.needs_alpha))
    np.testing.assert_array_equal(_np(ta.cluster_lo), np.asarray(ja.cluster_lo))
    np.testing.assert_array_equal(_np(ta.cluster_hi), np.asarray(ja.cluster_hi))
    np.testing.assert_array_equal(_np(ta.world_lo), np.asarray(ja.world_lo))
    np.testing.assert_array_equal(_np(ta.world_hi), np.asarray(ja.world_hi))
    # Woop rows: f32 rounding of two float64 inversions; the atol covers
    # entries that are 0 in exact arithmetic (axis-aligned quads)
    jw = np.asarray(ja.woop_w)
    np.testing.assert_allclose(_np(ta.woop_w), jw, rtol=1e-6, atol=1e-6 * np.abs(jw).max())
    np.testing.assert_allclose(_np(ta.tri_attr), np.asarray(ja.tri_attr), rtol=1e-6)
    assert ta.woop_w.shape == (3 * ta.scene.num_tris, 8)
    # candidacy baking (the any-hit tables' recipe) on the port's table
    keep = np.arange(ta.scene.num_tris) % 3 != 0
    np.testing.assert_array_equal(
        woop.bake_candidacy(_np(ta.woop_w), keep),
        j_woop.bake_candidacy(_np(ta.woop_w), keep),
    )


def test_atlas_matches_jax():
    jb, tb = j_procedural.city(), procedural.city(device="cpu")
    np.testing.assert_array_equal(_np(tb.atlas.table), np.asarray(jb.atlas.table))
    # sRGB decode: numpy's f32 pow vs XLA's, a few ulps
    np.testing.assert_allclose(_np(tb.atlas.flat), np.asarray(jb.atlas.flat), rtol=1e-6, atol=1e-7)


def test_sort_keys_bit_exact(rng):
    jb, tb = j_procedural.city(), procedural.city(device="cpu")
    ja, ta = j_build_accel(jb.scene, jb.atlas), build_accel(tb.scene, tb.atlas)
    o = rng.uniform(-200, 4200, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[:16] = 0.0  # sign ties
    ref = np.asarray(j_woop._sort_keys(ja, jnp.asarray(o), jnp.asarray(d)))
    ours = woop._sort_keys(ta, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(ours.numpy().astype(np.uint32), ref)


# ------------------------------------------------------------------ hits


def test_oracle_matches_jax_on_random_soup(rng):
    v0, v1, v2 = _random_soup(rng, spread=20.0)
    ja = j_build_accel(j_soup(v0, v1, v2))
    ta = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
    o, d = _soup_rays(rng, 1024)
    o[:512] = rng.uniform(-60, 60, (512, 3))  # all of them near the soup
    d[:512] = rng.normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = j_intersect(ja, jnp.asarray(o), jnp.asarray(d), 0.0, 1e4)
    ours = intersect(ta, torch.from_numpy(o), torch.from_numpy(d), 0.0, 1e4)
    assert (_np(ref.tri) >= 0).sum() > 100
    _assert_hits_match(ours, ref)
    hit = _np(ref.tri) >= 0
    np.testing.assert_allclose(_np(ours.u)[hit], np.asarray(ref.u)[hit], atol=1e-4)
    np.testing.assert_allclose(_np(ours.v)[hit], np.asarray(ref.v)[hit], atol=1e-4)


def test_oracle_matches_jax_on_city():
    jb, tb = j_procedural.city(), procedural.city(device="cpu")
    ja, ta = j_build_accel(jb.scene, jb.atlas), build_accel(tb.scene, tb.atlas)
    o, d = _city_primary(tb, 48, 32)
    ref = j_intersect(ja, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), 0.0, 1e4)
    ours = intersect(ta, o, d, 0.0, 1e4)
    _assert_hits_match(ours, ref)


def test_woop_reference_matches_jax_kernel_random_soup(rng):
    """intersect_woop (CPU: the plain version) vs the JAX Woop kernel in
    interpret mode, on test_accel.py:205's soup with half misses."""
    v0, v1, v2 = _random_soup(rng)
    ja = j_build_accel(j_soup(v0, v1, v2))
    ta = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
    o, d = _soup_rays(rng)
    ref = j_woop.intersect_woop(ja, jnp.asarray(o), jnp.asarray(d), 0.0, 1e4,
                                ray_block=256, interpret=True)
    ours = woop.intersect_woop(ta, torch.from_numpy(o), torch.from_numpy(d), 0.0, 1e4)
    _assert_hits_match(ours, ref)
    assert not (_np(ours.tri)[:256] >= 0).all()  # misses really occur
    # the coherence-sorted path scatters results back to the same order
    sorted_ = woop.intersect_woop(
        ta, torch.from_numpy(o), torch.from_numpy(d), 0.0, 1e4, sort_rays=True
    )
    for a, b in zip(sorted_, ours):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_woop_reference_matches_jax_kernel_city():
    jb, tb = j_procedural.city(), procedural.city(device="cpu")
    ja, ta = j_build_accel(jb.scene, jb.atlas), build_accel(tb.scene, tb.atlas)
    o, d = _city_primary(tb, 64, 64)  # 4,096 rays
    ref = j_woop.intersect_woop(ja, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                0.0, 1e4, ray_block=1024, interpret=True)
    ours = woop.intersect_woop(ta, o, d, 0.0, 1e4)
    _assert_hits_match(ours, ref)


def test_trace_nearest_alpha_grate():
    """test_accel.py:89's alpha-tested grates (outdoor court, built by
    the JAX package's procedural code and handed over as arrays)."""
    jb = j_procedural.outdoor_court()
    ja = j_build_accel(jb.scene, jb.atlas)
    atlas = interop.atlas_from_numpy(jb.atlas, device="cpu")
    ta = build_accel(interop.scene_from_numpy(jb.scene, device="cpu"), atlas)
    ys = np.linspace(110, 290, 64)
    o = np.asarray([[600.0, y, 80.0] for y in ys], np.float32)
    d = np.broadcast_to(np.asarray([1.0, 0.0, 0.0], np.float32), (64, 3)).copy()
    ref = j_trace_nearest(ja, jb.atlas, jnp.asarray(o), jnp.asarray(d), 0.0, materials.T_MAX)
    ours = trace_nearest(ta, atlas, torch.from_numpy(o), torch.from_numpy(d), 0.0, materials.T_MAX)
    _assert_hits_match(ours, ref)
    t = _np(ours.t)
    assert (np.abs(t - 40.0) < 1.5).any(), "some rays should hit the near grate"
    assert (t > 400).any(), "some rays should pass through grate holes"
    assert bool(ta.needs_alpha.any())


# ------------------------------------------------------------------ K1


def _model_k1(rays, w, lo, hi, mutant=None):
    """torch model of csrc/woop_nearest.cu's schedule (the walk of
    csrc/woop_walk.cuh in node order, tests/torch_walk_model.py): a warp
    of 32 rays at a time gates the node boxes, the sub-node boxes of
    reached nodes and the members of reached sub-nodes; a reached cluster
    is fetched at once and the tile before it tested then; a tile few
    lanes reach is tested triangle per lane with the (t, index) winner.
    Arithmetic in the plain version's order, so the result must be
    bit-equal."""
    return model_walk(rays, w, lo, hi, NODE, listed=False, mutant=mutant)


def _bounce_population(bundle, accel, width=48, height=32):
    from merian_quake_tpu_torch.models.types import RenderConfig
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
    return cur.pos - cur.wi * 1e-3, wo, torch.where(live, 1e4, -1.0)


def _k1_population(rng, population):
    """(rays, w, lo, hi) of one K1 test population. ``sparse``: city's
    primary rays with one or two live rays a warp (every tile visit is
    compacted); ``ties``: the hand-laid table with duplicated triangles."""
    if population == "ties":
        return tie_table("cpu")
    if population == "soup":
        v0, v1, v2 = _random_soup(rng)
        acc = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
        o, d = (torch.from_numpy(x) for x in _soup_rays(rng))
        t_min, t_max = torch.zeros(512), torch.full((512,), 1e4)
    else:
        bundle = procedural.city(device="cpu")
        acc = build_accel(bundle.scene, bundle.atlas)
        if population in ("primary", "sparse"):
            o, d = _city_primary(bundle, 48, 32)
            t_max = torch.full((o.shape[0],), 1e4)
            if population == "sparse":
                t_max = sparse_warps(t_max)
        else:
            o, d, t_max = _bounce_population(bundle, acc)
            perm = woop.sort_perm(acc, o, d, t_max)
            o, d, t_max = o[perm], d[perm], t_max[perm]
        t_min = torch.full((o.shape[0],), 1e-3 if population == "bounce_tmin" else 0.0)
    return woop.k1_inputs(acc, o.contiguous(), d.contiguous(), t_min, t_max.contiguous())


@pytest.mark.parametrize("population", ["soup", "primary", "bounce", "bounce_tmin", "sparse",
                                        "ties"])
def test_k1_schedule_matches_plain_version(rng, population):
    args = _k1_population(rng, population)
    t_ref, tri_ref = woop.intersect_woop_reference(args[0], args[1])
    t_mod, tri_mod = _model_k1(*args)
    assert (tri_ref >= 0).sum() > 0
    if population == "ties":  # some nearest hits lie on a duplicated triangle
        assert ((tri_ref >= 0) & (tri_ref < 128)).sum() > 0
    torch.testing.assert_close(tri_mod, tri_ref, rtol=0, atol=0)
    torch.testing.assert_close(t_mod, t_ref, rtol=0, atol=0)
    # the CPU wrapper is the plain version
    t_w, tri_w = woop.woop_nearest(*args)
    torch.testing.assert_close(tri_w, tri_ref, rtol=0, atol=0)


@pytest.mark.parametrize("mutant,population", [
    ("early_exit", "soup"), ("early_exit", "bounce"), ("compact_drops_last", "sparse"),
    ("compact_drops_last", "bounce"), ("winner_ignores_index", "ties"),
])
def test_k1_schedule_mutants_fail(rng, mutant, population):
    """Each mutant of the walk gives another result than the plain
    version: one that never walks the last node its warp reaches, a compacted visit that
    leaves out its last reaching ray, a compacted winner that takes the
    highest index among equal t."""
    args = _k1_population(rng, population)
    _, tri_ref = woop.intersect_woop_reference(args[0], args[1])
    _, tri_mod = _model_k1(*args, mutant=mutant)
    assert int((tri_mod != tri_ref).sum()) > 0


@pytest.mark.parametrize("name", ["city", "court"])
def test_packed_tables_and_cached_boxes(name):
    """Every Woop table build_accel places carries its packed rows
    (f32[3T, 4] = columns 0-3; columns 4-7 are zero), the padded bounds
    and the walk's boxes are computed once a table, and a table without
    packed rows is refused."""
    if name == "city":  # full, shadow (sky zeroed) and proxy tables
        ta = build_accel(*procedural.city(device="cpu")[:2])
        tables = [ta.woop_w, ta.woop_w_shadow, ta.woop_w_proxy]
        assert ta.woop_w_shadow is not ta.woop_w
    else:  # full, shadow and alpha-only tables
        jb = j_procedural.outdoor_court()
        ta = build_accel(interop.scene_from_numpy(jb.scene, device="cpu"),
                         interop.atlas_from_numpy(jb.atlas, device="cpu"))
        tables = [ta.woop_w, ta.woop_w_shadow, ta.woop_w_alpha]
    for w in tables:
        assert w is not None
        rows4 = woop.packed_rows(w)
        assert rows4.shape == (w.shape[0], 4) and rows4.is_contiguous()
        torch.testing.assert_close(rows4, w[:, :4], rtol=0, atol=0)
        assert not bool(w[:, 4:].any())
    with pytest.raises(ValueError, match="packed rows"):
        woop.packed_rows(ta.woop_w.clone())
    # the bounds and boxes: the same tensors every call, per (node, sub-node) size
    lo, hi = woop.padded_bounds(ta.cluster_lo, ta.cluster_hi)
    assert woop.padded_bounds(ta.cluster_lo, ta.cluster_hi)[0] is lo
    assert woop.k1_inputs(ta, torch.zeros(128, 3), torch.ones(128, 3), torch.zeros(128),
                          torch.ones(128))[2] is lo
    want_lo, want_hi = woop._pad_bounds(ta.cluster_lo, ta.cluster_hi)
    torch.testing.assert_close(lo, want_lo, rtol=0, atol=0)
    torch.testing.assert_close(hi, want_hi, rtol=0, atol=0)
    nc = lo.shape[0]
    for P, S in (NODE, (32, 8), (8, 8)):
        boxes = woop.walk_boxes(lo, hi, P, S)
        assert woop.walk_boxes(lo, hi, P, S) is boxes
        nn, ns = -(-nc // P), (-(-nc // S) if S < P else 0)
        assert boxes.shape == (nn + ns + nc, 8) and boxes.is_contiguous()
        nlo, nhi = woop.node_bounds(lo, hi, P)
        torch.testing.assert_close(boxes[:nn, 0:3], nlo, rtol=0, atol=0)
        torch.testing.assert_close(boxes[:nn, 4:7], nhi, rtol=0, atol=0)
        if ns:
            slo, shi = woop.node_bounds(lo, hi, S)
            torch.testing.assert_close(boxes[nn:nn + ns, 0:3], slo, rtol=0, atol=0)
            torch.testing.assert_close(boxes[nn:nn + ns, 4:7], shi, rtol=0, atol=0)
        torch.testing.assert_close(boxes[nn + ns:nn + ns + nc, 0:3], lo, rtol=0, atol=0)
        torch.testing.assert_close(boxes[nn + ns:nn + ns + nc, 4:7], hi, rtol=0, atol=0)
        # a node box holds its members: min/max of them, no rounding
        member = boxes[nn + ns:][: P * (nc // P)].reshape(nc // P, P, 8)
        assert bool((boxes[: nc // P, None, 0:3] <= member[..., 0:3]).all())
        torch.testing.assert_close(boxes[:, 3], (boxes[:, 0:3] > boxes[:, 4:7]).any(-1).float(),
                                   rtol=0, atol=0)
        assert not bool(boxes[:, 7].any())
    # other bounds get boxes of their own
    assert woop.walk_boxes(lo.clone(), hi, *NODE) is not woop.walk_boxes(lo, hi, *NODE)


def test_woop_nearest_rejects_bad_inputs(rng):
    v0, v1, v2 = _random_soup(rng, 64)
    acc = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
    o, d = (torch.from_numpy(x) for x in _soup_rays(rng, 256))
    args = list(woop.k1_inputs(acc, o, d, torch.zeros(256), torch.full((256,), 1e4)))
    for i, bad in (
        (0, args[0].double()),  # dtype
        (0, args[0][:, :200]),  # shape / block split
        (2, args[2].double()),  # bounds dtype
        (0, args[0].T.contiguous().T),  # not contiguous
    ):
        broken = list(args)
        broken[i] = bad
        with pytest.raises(ValueError):
            woop.woop_nearest(*broken)


@pytest.mark.cuda
def test_k1_kernel_matches_plain_version_on_card(rng):
    """K1 against its plain version on city's primary rays, bit for bit.
    The card's machine has no JAX, so this file cannot run there:
    chip_smoke.py phase 2 makes the same comparison on a 65,536-ray
    subset and on the whole 1080p primary population of city."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    bundle = procedural.city(device=dev)
    acc = build_accel(bundle.scene, bundle.atlas)
    o, d = _city_primary(bundle, 256, 256)
    n = o.shape[0]
    args = woop.k1_inputs(acc, o.to(dev), d.to(dev), torch.zeros(n, device=dev),
                          torch.full((n,), 1e4, device=dev))
    before = woop.woop_nearest.launches
    t_k, tri_k = woop.woop_nearest(*args)
    assert woop.woop_nearest.launches == before + 1
    t_r, tri_r = woop.intersect_woop_reference(args[0], args[1])
    torch.testing.assert_close(tri_k, tri_r, rtol=0, atol=0)
    torch.testing.assert_close(t_k, t_r, rtol=0, atol=0)


# ------------------------------------------------------------------ K2


def _mixed_soup(rng, t=4096, sky_share=0.0):
    """test_accel.py:376's soup: mixed scales, so that the proxy table
    really selects the big triangles; optionally some sky triangles."""
    c = rng.uniform(-40, 40, (t, 1, 3))
    scale = rng.uniform(0.5, 2.0, (t, 1, 1)) * np.where(rng.uniform(size=(t, 1, 1)) < 0.05, 12.0, 1.0)
    tri = (c + rng.uniform(-1, 1, (t, 3, 3)) * scale).astype(np.float32)
    flags = np.where(rng.uniform(size=t) < sky_share, materials.MAT_FLAGS_SKY, 0).astype(np.int32)
    return tri[:, 0], tri[:, 1], tri[:, 2], flags


def _shadow_rays(rng, n=512, lo=-60, hi=60):
    """test_accel.py:317's rays: random origins and directions, per-ray
    t_max in [1, 200]."""
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, rng.uniform(1.0, 200.0, (n,)).astype(np.float32)


def _clear_of_band(ta, o, d, t_max):
    """Oracle occlusion, and the rays outside the t_max boundary band."""
    ho = intersect(ta, torch.from_numpy(o), torch.from_numpy(d), 1e-3, torch.from_numpy(t_max))
    oh, tt = _np(ho.tri) >= 0, _np(ho.t)
    return oh, ~oh | (np.abs(tt - t_max) > 1e-3 * np.maximum(t_max, 1.0))


def _assert_table(ours, ref, exact=False):
    assert (ours is None) == (ref is None)
    if ours is None:
        return
    ref = np.asarray(ref)
    ours = _np(ours)
    assert ours.shape == ref.shape
    np.testing.assert_array_equal((ours == 0).all(-1), (ref == 0).all(-1))  # masks
    if exact:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["city", "soup", "court"])
def test_anyhit_tables_match_jax(rng, name):
    if name == "city":
        ja = j_build_accel(*j_procedural.city()[:2])
        ta = build_accel(*procedural.city(device="cpu")[:2])
    elif name == "soup":  # proxy + sky-zeroed shadow rows, no alpha
        v0, v1, v2, flags = _mixed_soup(rng, sky_share=0.05)
        ja = j_build_accel(j_soup(v0, v1, v2, flags=flags))
        ta = build_accel(build_scene_from_soup(v0, v1, v2, flags=flags, device="cpu"))
    else:  # alpha grates, sky walls; built by the JAX package, carried across
        jb = j_procedural.outdoor_court()
        ja = j_build_accel(jb.scene, jb.atlas)
        ta = build_accel(interop.scene_from_numpy(jb.scene, device="cpu"), interop.atlas_from_numpy(jb.atlas, device="cpu"))
    assert (ta.woop_w_shadow is ta.woop_w) == (ja.woop_w_shadow is ja.woop_w)
    _assert_table(ta.woop_w_shadow, ja.woop_w_shadow)
    _assert_table(ta.woop_w_alpha, ja.woop_w_alpha)
    _assert_table(ta.cluster_lo_alpha, ja.cluster_lo_alpha, exact=True)
    _assert_table(ta.cluster_hi_alpha, ja.cluster_hi_alpha, exact=True)
    _assert_table(ta.woop_w_proxy, ja.woop_w_proxy)
    _assert_table(ta.cluster_lo_proxy, ja.cluster_lo_proxy, exact=True)
    _assert_table(ta.cluster_hi_proxy, ja.cluster_hi_proxy, exact=True)
    expect = {"city": (False, False, True), "soup": (False, False, True), "court": (False, True, False)}
    has = (ta.woop_w_shadow is ta.woop_w, ta.woop_w_alpha is not None, ta.woop_w_proxy is not None)
    assert has == expect[name]


def test_k2_plain_matches_jax_anyhit_and_oracle(rng):
    """Twin of test_accel.py:317: no sky or alpha, so K2 and the oracle
    mean the same; per-ray t_max and rays that miss everything."""
    v0, v1, v2 = _random_soup(rng)
    ja = j_build_accel(j_soup(v0, v1, v2))
    ta = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
    assert ta.woop_w_shadow is ta.woop_w and ta.woop_w_proxy is None
    o, d, t_max = _shadow_rays(rng)
    ref = np.asarray(j_woop.intersect_woop_any(
        ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max), ray_block=256, interpret=True,
    ))
    ours = _np(woop.intersect_woop_any(ta, torch.from_numpy(o), torch.from_numpy(d), 1e-3,
                                       torch.from_numpy(t_max)))
    oh, clear = _clear_of_band(ta, o, d, t_max)
    np.testing.assert_array_equal(ours[clear], ref[clear])
    np.testing.assert_array_equal(ours[clear], oh[clear])
    assert oh.any() and (~oh).any() and clear.mean() > 0.95


def test_k2_proxy_prepass_matches_jax_and_oracle(rng):
    """Twin of test_accel.py:376 (the proxy pre-pass), plus: the pre-pass
    changes no ray, K2(shadow, occluded_in=K2(proxy)) == K2(shadow)."""
    v0, v1, v2, _ = _mixed_soup(rng)
    ja = j_build_accel(j_soup(v0, v1, v2))
    ta = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
    assert ta.woop_w_proxy is not None and ta.cluster_lo_proxy.shape[0] >= 2
    o, d, t_max = _shadow_rays(rng, lo=-50, hi=50)
    ref = np.asarray(j_woop.intersect_woop_any(
        ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max), ray_block=256, interpret=True,
    ))
    ot, dt, tt = (torch.from_numpy(x) for x in (o, d, t_max))
    ours = _np(woop.intersect_woop_any(ta, ot, dt, 1e-3, tt))
    oh, clear = _clear_of_band(ta, o, d, t_max)
    np.testing.assert_array_equal(ours[clear], ref[clear])
    np.testing.assert_array_equal(ours[clear], oh[clear])
    assert oh.any() and (~oh).any()
    rays, proxy, shadow = woop.k2_inputs(ta, ot, dt, torch.full((512,), 1e-3), tt)
    pre = woop.woop_any(rays, *proxy)
    assert pre.any()  # the proxy really occludes some rays
    torch.testing.assert_close(woop.woop_any(rays, *shadow, pre), woop.woop_any(rays, *shadow), rtol=0, atol=0)
    # the coherence-sorted path scatters results back to the same order
    sorted_ = woop.intersect_woop_any(ta, ot, dt, 1e-3, tt, sort_rays=True)
    np.testing.assert_array_equal(_np(sorted_), ours)


def _sky_soup():
    """An opaque wall at x = 20 behind a sky wall at x = 10, each
    two-sided (one quad per facing)."""
    quads, flags = [], []
    for x, flag in ((10.0, materials.MAT_FLAGS_SKY), (20.0, 0)):
        a, b, c, e = ([x, -5, -5], [x, 5, -5], [x, 5, 5], [x, -5, 5])
        quads += [(a, e, b), (c, b, e), (a, b, e), (c, e, b)]
        flags += [flag] * 4
    tri = np.asarray(quads, np.float32)
    return tri[:, 0], tri[:, 1], tri[:, 2], np.asarray(flags, np.int32)


def test_k2_sky_quad_in_front_of_occluder():
    """Sky passes light in K2 (its rows are zeroed in the shadow table), so
    the wall behind it occludes; the CPU oracle commits the nearer sky hit
    and calls the segment visible. Both are what the JAX package does."""
    v0, v1, v2, flags = _sky_soup()
    ja = j_build_accel(j_soup(v0, v1, v2, flags=flags))
    ta = build_accel(build_scene_from_soup(v0, v1, v2, flags=flags, device="cpu"))
    assert ta.woop_w_shadow is not ta.woop_w
    o = np.zeros((4, 3), np.float32)
    o[:, 1:] = [[0, 0], [1, 1], [-2, 3], [4, -4]]
    to = o + np.asarray([30.0, 0.0, 0.0], np.float32)
    d = np.tile(np.asarray([[1.0, 0.0, 0.0]], np.float32), (4, 1))
    t_max = np.full((4,), 30.0 - 2e-3, np.float32)
    occ = woop.intersect_woop_any(ta, torch.from_numpy(o), torch.from_numpy(d), 1e-3, torch.from_numpy(t_max))
    j_occ = j_woop.intersect_woop_any(ja, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max),
                                      ray_block=128, interpret=True)
    assert bool(occ.all()) and bool(np.asarray(j_occ).all())
    vis = trace_visibility(ta, None, torch.from_numpy(o), torch.from_numpy(to))
    j_vis = j_trace_visibility(ja, None, jnp.asarray(o), jnp.asarray(to))
    assert bool(vis.all()) and bool(np.asarray(j_vis).all())
    # a segment that ends before the sky wall is visible in both
    short = o + np.asarray([5.0, 0.0, 0.0], np.float32)
    assert bool(trace_visibility(ta, None, torch.from_numpy(o), torch.from_numpy(short)).all())
    assert not bool(woop.intersect_woop_any(ta, torch.from_numpy(o), torch.from_numpy(d), 1e-3, 5.0).any())


def _model_k2(rays, w, lo, hi, occluded_in=None, mutant=None):
    """torch model of csrc/woop_any.cu's schedule: the any-hit instance of
    the walk of csrc/woop_walk.cuh (tests/torch_walk_model.py) in the
    order the kernel launches (K2_LISTED): a warp of 32 rays gates node,
    sub-node and cluster boxes with limit slack(t_max), -inf once
    occluded (or occluded on entry: the warm start), fetches a reached
    tile one ahead and tests it on the lanes that still reach it, triangle
    per lane when few do; the warp's walk ends once every live lane is
    occluded. Must equal the plain version on every ray."""
    return model_walk(rays, w, lo, hi, NODE, listed=K2_LISTED, anyhit=True,
                      occluded_in=occluded_in, mutant=mutant)


def _city_shadow_rays(bundle, accel, width=48, height=32):
    """Gbuffer points to the hit points of one bounce each (from the
    bounce population), and to random points in the city's bounds."""
    from merian_quake_tpu_torch.render.gbuffer import render_gbuffer
    from merian_quake_tpu_torch.render.hit import decompress_hit
    from merian_quake_tpu_torch.models.types import RenderConfig

    o, d, t_max = _bounce_population(bundle, accel, width, height)
    hr = intersect(accel, o, d, 0.0, 1e4)
    to = torch.where(hr.hit[:, None], o + d * hr.t[:, None], o + d * 500.0)
    g = torch.Generator().manual_seed(5)
    lo, hi = accel.world_lo, accel.world_hi
    rnd = lo + (hi - lo) * torch.rand(to.shape, generator=g)
    to = torch.cat([to, rnd])
    cfg = RenderConfig(width=width, height=height)
    pos = decompress_hit(render_gbuffer(accel, bundle.atlas, bundle.uniforms, cfg).hits).pos
    frm = torch.cat([pos, pos])
    wo = to - frm
    dist = torch.linalg.vector_norm(wo, dim=-1)
    dd = wo / torch.clamp_min(dist, 1e-20)[:, None]
    return frm.contiguous(), dd.contiguous(), torch.clamp_min(dist - 2e-3, 1e-3).contiguous()


def _staggered_segments(acc, warps=4):
    """Short shadow segments in the city, each ending just behind the
    centroid of one shadow-table triangle (the largest of its cluster),
    aimed at its front face: a warp's 32 lanes take triangles of 32
    different clusters in cluster order, so they are occluded one tile
    after another and the last lane only by a late tile."""
    w = acc.woop_w_shadow
    nc = acc.cluster_lo.shape[0]
    v0, v1, v2 = acc.scene.v0, acc.scene.v1, acc.scene.v2
    n_ref = torch.linalg.cross(v2 - v0, v1 - v0)
    area = torch.linalg.vector_norm(n_ref, dim=-1)
    shadow = w.reshape(nc, 3, 64, 8).abs().sum((1, 3)).reshape(-1) > 0
    score = torch.where(shadow & (area > 1.0), area, 0.0).reshape(nc, 64)
    best, idx = score.max(1)
    clusters = torch.nonzero(best > 0)[:, 0]
    g = torch.Generator().manual_seed(3)
    picks = [clusters[torch.randperm(len(clusters), generator=g)[:32]].sort().values
             for _ in range(warps)]
    tris = torch.cat([cs * 64 + idx[cs] for cs in picks])
    d = -n_ref[tris] / area[tris, None]
    o = (v0[tris] + v1[tris] + v2[tris]) / 3.0 - d * 0.5
    return o, d, torch.ones(len(tris))


def _k2_population(rng, population):
    """(n, rays, proxy, shadow) of one K2 test population. ``city_covered``:
    segments from above the city straight down through its ground (the
    proxy table's largest triangles), so the proxy pre-pass leaves whole
    warps occluded on entry, then city's shadow rays; ``city_staggered``:
    :func:`_staggered_segments`, then city's shadow rays."""
    if population == "soup":
        v0, v1, v2, flags = _mixed_soup(rng, sky_share=0.05)
        acc = build_accel(build_scene_from_soup(v0, v1, v2, flags=flags, device="cpu"))
        o, d, t_max = (torch.from_numpy(x) for x in _shadow_rays(rng, lo=-50, hi=50))
    else:
        bundle = procedural.city(device="cpu")
        acc = build_accel(bundle.scene, bundle.atlas)
        o, d, t_max = _city_shadow_rays(bundle, acc, 32, 16)
        if population == "city_staggered":
            so, sd, st = _staggered_segments(acc)
            o, d, t_max = torch.cat([so, o]), torch.cat([sd, d]), torch.cat([st, t_max])
        elif population == "city_covered":
            g = torch.Generator().manual_seed(9)
            m = 256
            top = acc.world_lo + (acc.world_hi - acc.world_lo) * torch.rand((m, 3), generator=g)
            top[:, 2] = acc.world_hi[2] - 1.0
            down = torch.tensor([0.0, 0.0, -1.0]).expand(m, 3)
            o, d = torch.cat([top, o]), torch.cat([down, d])
            t_max = torch.cat([torch.full((m,), float(acc.world_hi[2]) + 50.0), t_max])
    n = o.shape[0]
    return (n, *woop.k2_inputs(acc, o.contiguous(), d.contiguous(), torch.full((n,), 1e-3),
                               t_max.contiguous()))


@pytest.mark.parametrize("population", ["soup", "city", "city_covered", "city_staggered"])
def test_k2_schedule_matches_plain_version(rng, population):
    n, rays, proxy, shadow = _k2_population(rng, population)
    dense = woop.intersect_woop_any_reference(rays, shadow[0])
    assert dense[:n].any() and (~dense[:n]).any()
    torch.testing.assert_close(_model_k2(rays, *shadow), dense, rtol=0, atol=0)
    pre = _model_k2(rays, *proxy)
    torch.testing.assert_close(pre, woop.intersect_woop_any_reference(rays, proxy[0]), rtol=0, atol=0)
    assert pre.any()
    if population == "city_covered":  # some warps are wholly occluded on entry, some not
        warps = pre.reshape(-1, 32).all(1)
        assert warps.any() and (~warps).any()
    if population == "city_staggered":  # every staggered segment is occluded
        assert dense[:128].all()
    # the warm start
    torch.testing.assert_close(_model_k2(rays, *shadow, pre), dense, rtol=0, atol=0)
    # the CPU wrapper is the plain version, warm start included
    torch.testing.assert_close(woop.woop_any(rays, *shadow, pre), dense, rtol=0, atol=0)


@pytest.mark.parametrize("mutant", ["early_exit", "stops_before_all_occluded"])
def test_k2_schedule_mutants_fail(rng, mutant):
    """Each any-hit mutant of the walk gives another occlusion than the
    plain version on city's shadow rays (with segments that are occluded
    one tile after another, :func:`_staggered_segments`): a walk that ends early
    (K1's order: the last node a warp reaches is never walked; the list:
    one node early), and a warp that ends its walk before every live lane
    is occluded."""
    _, rays, _, shadow = _k2_population(rng, "city_staggered")
    ref = woop.intersect_woop_any_reference(rays, shadow[0])
    out = _model_k2(rays, *shadow, mutant=mutant)
    assert int((out != ref).sum()) > 0


def test_woop_any_rejects_bad_inputs(rng):
    v0, v1, v2 = _random_soup(rng, 64)
    acc = build_accel(build_scene_from_soup(v0, v1, v2, device="cpu"))
    o, d = (torch.from_numpy(x) for x in _soup_rays(rng, 256))
    rays, _, (w, lo, hi) = woop.k2_inputs(acc, o, d, torch.full((256,), 1e-3), torch.full((256,), 1e4))
    good = torch.zeros(256, dtype=torch.bool)
    for args, occ in (
        ((rays.double(), w, lo, hi), good),  # dtype
        ((rays[:, :200], w, lo, hi), good),  # shape / block split
        ((rays, w, lo[:-1] if lo.shape[0] > 1 else lo.double(), hi), good),  # bounds
        ((rays, w, lo, hi), good.to(torch.uint8)),  # warm start dtype
        ((rays, w, lo, hi), good[:128]),  # warm start shape
    ):
        with pytest.raises(ValueError):
            woop.woop_any(*args, occ)


# ------------------------------------------------------------------ visibility


def test_trace_visibility_through_box():
    """Twin of test_accel.py:116 on both packages' cornell_box."""
    jb, tb = j_procedural.cornell_box(), procedural.cornell_box(device="cpu")
    ja, ta = j_build_accel(jb.scene, jb.atlas), build_accel(tb.scene, tb.atlas)
    a = np.asarray([[60.0, 256.0, 130.0]] * 2, np.float32)
    bc = np.asarray([[200.0, 256.0, 130.0], [345.0, 335.0, 60.0]], np.float32)  # open air, block
    ref = np.asarray(j_trace_visibility(ja, jb.atlas, jnp.asarray(a), jnp.asarray(bc)))
    ours = _np(trace_visibility(ta, tb.atlas, torch.from_numpy(a), torch.from_numpy(bc)))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, [True, False])
    # the card's composition (K2, then the alpha table) gives the same
    at, bt = torch.from_numpy(a), torch.from_numpy(bc)
    d, t_max = _segments(at, bt)
    np.testing.assert_array_equal(_np(intersect_mod._visible_anyhit(ta, tb.atlas, at, d, 1e-3, t_max)),
                                  [True, False])


def _segments(a, b):
    """Unit directions and t_max of trace_visibility's segments a → b."""
    wo = b - a
    dist = torch.linalg.vector_norm(wo, dim=-1)
    return wo / dist[:, None], torch.clamp_min(dist - 2e-3, 1e-3)


def test_trace_visibility_outdoor_court(rng, monkeypatch):
    """Random segments inside the court (alpha grates, water, sky walls):
    the CPU oracle path against the JAX package's CPU path, and the
    card's composition (plain K2 on the shadow table, then the alpha loop
    on the alpha-only table through plain K1) against both, outside the
    t_max boundary band."""
    jb = j_procedural.outdoor_court()
    ja = j_build_accel(jb.scene, jb.atlas)
    atlas = interop.atlas_from_numpy(jb.atlas, device="cpu")
    ta = build_accel(interop.scene_from_numpy(jb.scene, device="cpu"), atlas)
    lo, hi = _np(ta.world_lo), _np(ta.world_hi)
    n = 1024
    a = (lo + (hi - lo) * rng.uniform(0.02, 0.98, (n, 3))).astype(np.float32)
    b = (lo + (hi - lo) * rng.uniform(0.02, 0.98, (n, 3))).astype(np.float32)
    # half of the segments cross the grates' plane region head-on
    b[: n // 2, 1:] = a[: n // 2, 1:]
    ref = np.asarray(j_trace_visibility(ja, jb.atlas, jnp.asarray(a), jnp.asarray(b)))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    ours = _np(trace_visibility(ta, atlas, at, bt))
    d, t_max = _segments(at, bt)
    hr = trace_nearest(ta, atlas, at, d, 1e-3, t_max)
    clear = ~_np(hr.hit) | (np.abs(_np(hr.t) - _np(t_max)) > 1e-3 * np.maximum(_np(t_max), 1.0))
    np.testing.assert_array_equal(ours[clear], ref[clear])
    assert clear.mean() > 0.99 and ours.any() and (~ours).any()
    # the card's composition, with plain versions of K1 and K2
    monkeypatch.setattr(intersect_mod, "intersect",
                        lambda acc, o, d, t0, t1, sort_rays=False, schedule=None:
                        woop.intersect_woop(acc, o, d, t0, t1, schedule=schedule))
    card = _np(intersect_mod._visible_anyhit(ta, atlas, at, d, 1e-3, t_max))
    np.testing.assert_array_equal(card[clear], ours[clear])
    assert ta.woop_w_alpha is not None


@pytest.mark.cuda
def test_k2_kernel_matches_plain_version_on_card():
    """K2 against its plain version on city's shade-pass shadow rays (the
    proxy pre-pass, then the shadow table warm-started by it). On the
    card: chip_smoke.py phase 5 ("city shade ... proxy / shadow / shadow
    after proxy", a 65,536-ray subset and the whole population)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda")
    bundle = procedural.city(device="cpu")
    acc = build_accel(bundle.scene, bundle.atlas)
    o, d, t_max = _city_shadow_rays(bundle, acc, 256, 128)
    acc = build_accel(bundle.scene, bundle.atlas, device=dev)
    n = o.shape[0]
    rays, proxy, shadow = woop.k2_inputs(acc, o.to(dev), d.to(dev), torch.full((n,), 1e-3, device=dev),
                                         t_max.to(dev))
    before = woop.woop_any.launches
    pre = woop.woop_any(rays, *proxy)
    occ = woop.woop_any(rays, *shadow, pre)
    assert woop.woop_any.launches == before + 2
    torch.testing.assert_close(pre, woop.intersect_woop_any_reference(rays, proxy[0]), rtol=0, atol=0)
    torch.testing.assert_close(occ, woop.intersect_woop_any_reference(rays, shadow[0]), rtol=0, atol=0)
