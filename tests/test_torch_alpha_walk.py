"""The alpha walk's plain version and its glue, on the CPU.

``woop.woop_alpha_reference`` is the plain version of the alpha walk
(csrc/woop_alpha.cu): the whole alpha re-trace loop of ``trace_nearest``
for K1's and K3's routes in one launch. Here it is held

- bit for bit in (t, tri, u, v) against the port's round loop
  (``trace_nearest`` with ``intersect`` sent through ``woop.intersect_woop``,
  whose K1 on the CPU is ``intersect_woop_reference``), and
- against the JAX package's ``trace_nearest`` (Möller–Trumbore on the CPU):
  tri equal where t is unique, t, u and v within test_torch_accel.py's
  tolerance,

on inputs made with numpy from seeds: an alpha-grate soup, a stack of
seven planes that reject every hit (each ray ends unhit after
MAX_INTERSECTIONS rounds in both packages), rays that start between
grates, dead rays (t_max -1), out-of-range texnum and negative and
wrapping UVs. The card's glue (``woop.intersect_woop_alpha``: one sort of
the rays, the walk, the scatter back) runs here with the wrappers' plain
versions and is held against the round loop too. The kernel itself needs
the card: the ``cuda`` test skips here and names chip_smoke.py's phase 39,
which holds both instances bit for bit against the plain version and the
eager round loop there.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.accel import build_accel as j_build_accel
from merian_quake_tpu.accel import trace_nearest as j_trace_nearest
from merian_quake_tpu.models import atlas as j_atlas
from merian_quake_tpu.models import materials
from merian_quake_tpu.models import procedural as j_procedural
from merian_quake_tpu_torch import interop
from merian_quake_tpu_torch.accel import build_accel, trace_nearest, woop
from test_torch_accel import T_ATOL, T_RTOL, _assert_hits_match

# the module (the package's ``intersect`` attribute is the function)
intersect_mod = importlib.import_module("merian_quake_tpu_torch.accel.intersect")

# The suite runs several test processes side by side on a few cores;
# torch would start one thread per core in each and oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

SEEDS = (0, 1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _grate(period):
    """A 16-texel grate texture: opaque bars every ``period`` texels, the
    rest transparent."""
    tex = j_procedural._const_tex((120, 120, 120), size=16, alpha=0)
    tex[:, ::period, 3] = 255
    tex[::period, :, 3] = 255
    return tex


def _room(rng):
    """A box room 200 x 100 x 100 with two two-sided grates across it and an
    opaque pillar (chip_smoke.py's grate soup); the grates' UV scale comes
    from the seed."""
    b = j_procedural._SoupBuilder()
    X, Y, Z = 200.0, 100.0, 100.0
    for p, du, dv in (((0, 0, 0), (X, 0, 0), (0, Y, 0)), ((0, 0, Z), (0, Y, 0), (X, 0, 0)),
                      ((0, 0, 0), (0, Y, 0), (0, 0, Z)), ((X, 0, 0), (0, 0, Z), (0, Y, 0)),
                      ((0, 0, 0), (0, 0, Z), (X, 0, 0)), ((0, Y, 0), (X, 0, 0), (0, 0, Z))):
        b.quad(p, du, dv, texnum=1)
    s = float(rng.uniform(3.0, 7.0))
    for x in (60.0, 130.0):
        b.quad((x, 0, 0), (0, Y, 0), (0, 0, Z), uv_scale=(s, s), texnum=2)
        b.quad((x, 0, 0), (0, 0, Z), (0, Y, 0), uv_scale=(s, s), texnum=2)
    b.quad((95, 40, 0), (0, 0, Z), (0, 20, 0), texnum=1)
    b.quad((95, 40, 0), (0, 20, 0), (0, 0, Z), texnum=1)
    atlas = j_atlas.pack_textures([j_procedural._const_tex((255, 255, 255), 1),
                                   j_procedural._const_tex((200, 200, 200)), _grate(4)])
    return b.build(), atlas


def _room_rays(rng, n=384):
    o = rng.uniform([2, 2, 2], [198, 98, 98], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _stack(n_planes, textures, x0=20.0, dx=15.0):
    """Two-sided planes across x = x0 + k·dx (plane k textured
    ``2 + k % len(textures)``) in front of an opaque wall."""
    b = j_procedural._SoupBuilder()
    for k in range(n_planes):
        x = x0 + dx * k
        b.quad((x, 0, 0), (0, 100.0, 0), (0, 0, 100.0), texnum=2 + k % len(textures))
        b.quad((x, 0, 0), (0, 0, 100.0), (0, 100.0, 0), texnum=2 + k % len(textures))
    b.quad((x0 + dx * n_planes, 0, 0), (0, 0, 100.0), (0, 100.0, 0), texnum=1)
    atlas = j_atlas.pack_textures([j_procedural._const_tex((255, 255, 255), 1),
                                   j_procedural._const_tex((200, 200, 200))] + list(textures))
    return b.build(), atlas


def _case_grate_soup(rng):
    scene, atlas = _room(rng)
    o, d = _room_rays(rng)
    return scene, atlas, o, d, np.full(len(o), materials.T_MAX, np.float32), None


def _case_seven_planes(rng):
    """Seven planes whose texture is transparent everywhere: every ray is
    rejected MAX_INTERSECTIONS times and ends unhit (the wall lies past
    the seventh plane)."""
    scene, atlas = _stack(7, [j_procedural._const_tex((90, 90, 90), alpha=0)], x0=10.0,
                          dx=10.0)
    n = 256
    o = np.concatenate([np.zeros((n, 1)), rng.uniform(2.0, 98.0, (n, 2))], 1).astype(np.float32)
    d = np.broadcast_to(np.asarray([1.0, 0.0, 0.0], np.float32), (n, 3)).copy()
    return scene, atlas, o, d, np.full(n, materials.T_MAX, np.float32), None


def _case_between_grates(rng):
    """Five grates, each opaque only on its texel row and column k; rays
    start between grates and go either way along x."""
    grates = []
    for k in range(5):
        tex = j_procedural._const_tex((120, 120, 120), size=8, alpha=0)
        tex[k, :, 3] = tex[:, k, 3] = 255
        grates.append(tex)
    scene, atlas = _stack(5, grates)
    n = 320
    gap = rng.integers(0, 5, n)
    x = 20.0 + 15.0 * gap + rng.uniform(1.0, 14.0, n)
    o = np.stack([x, rng.uniform(2.0, 98.0, n), rng.uniform(2.0, 98.0, n)], 1).astype(np.float32)
    d = np.zeros((n, 3), np.float32)
    d[:, 0] = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
    d[:, 1:] = rng.normal(scale=0.05, size=(n, 2))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return scene, atlas, o, d, np.full(n, materials.T_MAX, np.float32), None


def _case_dead_rays(rng):
    """The grate soup with a random third of the rays dead (t_max -1) and
    one whole warp of 32 dead."""
    scene, atlas, o, d, t_max, _ = _case_grate_soup(rng)
    t_max[rng.uniform(size=len(t_max)) < 1.0 / 3.0] = -1.0
    t_max[64:96] = -1.0
    return scene, atlas, o, d, t_max, None


def _case_texnum_out_of_range(rng):
    """The grate soup with the alpha-tested triangles' texnum set past the
    atlas's table or below 0 after the build (needs_alpha kept): the alpha
    test samples the clamped table entry, as atlas.sample_nearest does."""
    scene, atlas, o, d, t_max, _ = _case_grate_soup(rng)

    def edit(sc, needs):
        tex = np.asarray(sc.texnum).copy()
        pick = np.asarray(needs)
        tex[pick] = rng.choice([-7, -1, 4000, 70000], int(pick.sum()))
        return {"texnum": tex}

    return scene, atlas, o, d, t_max, edit


def _case_wrapping_uv(rng):
    """The grate soup with every triangle's UVs mapped to negative values
    and past 1 (a per-triangle scale and offset from the seed) after the
    build: GL_REPEAT wraps them."""
    scene, atlas, o, d, t_max, _ = _case_grate_soup(rng)

    def edit(sc, needs):
        st = np.asarray(sc.st)
        T = st.shape[0]
        scale = rng.uniform(-9.0, 9.0, (T, 1, 2)).astype(np.float32)
        off = rng.uniform(-20.0, 20.0, (T, 1, 2)).astype(np.float32)
        return {"st": (st * scale + off).astype(np.float32)}

    return scene, atlas, o, d, t_max, edit


CASES = {"grate_soup": _case_grate_soup, "seven_planes": _case_seven_planes,
         "between_grates": _case_between_grates, "dead_rays": _case_dead_rays,
         "texnum_out_of_range": _case_texnum_out_of_range, "wrapping_uv": _case_wrapping_uv}


def _make(case, seed):
    """Both packages' accels and atlases and the rays of ``case`` at
    ``seed``: (ja, j_atlas, ta, t_atlas, o, d, t_max) with o, d, t_max
    numpy."""
    rng = np.random.default_rng(1000 * seed + sorted(CASES).index(case))
    scene, atlas, o, d, t_max, edit = CASES[case](rng)
    ja = j_build_accel(scene, atlas)
    t_atlas = interop.atlas_from_numpy(atlas, device="cpu")
    ta = build_accel(interop.scene_from_numpy(scene, device="cpu"), t_atlas)
    np.testing.assert_array_equal(_np(ta.needs_alpha), np.asarray(ja.needs_alpha))
    assert bool(ta.needs_alpha.any())
    if edit is not None:
        fields = edit(ja.scene, ja.needs_alpha)
        ja = ja._replace(scene=ja.scene._replace(**{k: jnp.asarray(v) for k, v in fields.items()}))
        ta = ta._replace(scene=ta.scene._replace(**{k: torch.from_numpy(v)
                                                    for k, v in fields.items()}))
    return ja, atlas, ta, t_atlas, o, d, t_max


def _round_loop(monkeypatch, ta, t_atlas, o, d, t_max):
    """The port's round loop with every round's trace through
    ``woop.intersect_woop`` (K1's plain version on the CPU)."""
    with monkeypatch.context() as m:
        m.setattr(intersect_mod, "intersect",
                  lambda acc, o_, d_, t0, t1, sort_rays=False, schedule=None:
                  woop.intersect_woop(acc, o_, d_, t0, t1, sort_rays=sort_rays, schedule=schedule))
        return trace_nearest(ta, t_atlas, torch.from_numpy(o), torch.from_numpy(d), 0.0,
                             torch.from_numpy(t_max))


def _plain(ta, t_atlas, o, d, t_max):
    """woop_alpha_reference on the packed rays, cut to the real rays."""
    n = len(o)
    rays, w, _, _ = woop.k1_inputs(ta, torch.from_numpy(o), torch.from_numpy(d),
                                   torch.zeros(n), torch.from_numpy(t_max))
    out = woop.woop_alpha_reference(rays, w, woop.alpha_tables(ta, t_atlas), n=n)
    return intersect_mod.HitRecord(*(x[:n] for x in out))


def _assert_same_bits(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_alpha_reference_matches_round_loop(case, seed, monkeypatch):
    _, _, ta, t_atlas, o, d, t_max = _make(case, seed)
    plain = _plain(ta, t_atlas, o, d, t_max)
    _assert_same_bits(plain, _round_loop(monkeypatch, ta, t_atlas, o, d, t_max))
    assert bool((plain.tri >= 0).any()) or case == "seven_planes"


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_alpha_reference_matches_jax(case, seed):
    ja, atlas, ta, t_atlas, o, d, t_max = _make(case, seed)
    plain = _plain(ta, t_atlas, o, d, t_max)
    ref = j_trace_nearest(ja, atlas, jnp.asarray(o), jnp.asarray(d), 0.0, jnp.asarray(t_max))
    _assert_hits_match(plain, ref)
    same = _np(plain.tri) == np.asarray(ref.tri)
    for ours, theirs in ((plain.u, ref.u), (plain.v, ref.v)):
        np.testing.assert_allclose(_np(ours)[same], np.asarray(theirs)[same], rtol=T_RTOL,
                                   atol=T_ATOL)
    if case == "dead_rays":
        assert (_np(plain.tri)[t_max < 0] == -1).all()


def test_seven_planes_end_unhit_in_both_packages():
    ja, atlas, ta, t_atlas, o, d, t_max = _make("seven_planes", 0)
    plain = _plain(ta, t_atlas, o, d, t_max)
    ref = j_trace_nearest(ja, atlas, jnp.asarray(o), jnp.asarray(d), 0.0, jnp.asarray(t_max))
    assert (_np(plain.tri) == -1).all() and (np.asarray(ref.tri) == -1).all()
    assert (_np(plain.t) > 1e38).all() and (np.asarray(ref.t) > 1e38).all()
    # with two more rounds than planes the wall, past the seventh, is hit
    rays, w, _, _ = woop.k1_inputs(ta, torch.from_numpy(o), torch.from_numpy(d),
                                   torch.zeros(len(o)), torch.from_numpy(t_max))
    far = woop.woop_alpha_reference(rays, w, woop.alpha_tables(ta, t_atlas), 8, n=len(o))
    assert (_np(far[0])[: len(o)] == 80.0).all()


@pytest.mark.parametrize("sort_rays", [False, True])
@pytest.mark.parametrize("stream", [False, True])
def test_card_glue_matches_round_loop(stream, sort_rays, monkeypatch):
    """``woop.intersect_woop_alpha``, the card's path (one sort of the rays,
    the walk, the scatter back), with the walk's plain version: the round
    loop's bits, sorted or not, on either instance."""
    _, _, ta, t_atlas, o, d, t_max = _make("dead_rays", 0)
    loop = _round_loop(monkeypatch, ta, t_atlas, o, d, t_max)
    called = []
    for name in ("woop_nearest_alpha", "woop_stream_alpha"):
        plain = getattr(woop, name)
        monkeypatch.setattr(woop, name, lambda *a, _p=plain, _n=name, **k: (called.append(_n),
                                                                              _p(*a, **k))[1])
    monkeypatch.setattr(woop, "streamed", lambda w: stream)
    hr = woop.intersect_woop_alpha(ta, t_atlas, torch.from_numpy(o), torch.from_numpy(d), 0.0,
                                   torch.from_numpy(t_max), sort_rays=sort_rays)
    _assert_same_bits(hr, loop)
    assert called == ["woop_stream_alpha" if stream else "woop_nearest_alpha"]


def test_trace_route_predicate():
    """Which nearest-hit traces go to the list walker (and so keep the
    round loop on the card): a resident table under a node level, a
    compaction or a target key that sorts the rays; never a streamed one."""
    _, _, ta, _, _, _, _ = _make("grate_soup", 0)
    n = 4096
    assert not woop.walks_list(ta, n)
    assert not woop.walks_list(ta, n, sort_rays=True)
    assert woop.walks_list(ta, n, schedule=(False, 8, 0)) == (ta.num_clusters > 8)
    assert woop.walks_list(ta, n, schedule=(False, 0, 32))
    assert woop.walks_list(ta, n, sort_rays=True, schedule=(True, 0, 0))
    assert not woop.walks_list(ta, n, sort_rays=False, schedule=(True, 0, 0))
    assert not woop.walks_list(ta, 64, sort_rays=True, schedule=(True, 0, 0))
    big = ta._replace(woop_w=torch.zeros(3 * (woop.RESIDENT_MAX_TRIS + 64), 8))
    assert not woop.walks_list(big, n, schedule=(True, 8, 32))


def test_cpu_trace_nearest_keeps_the_round_loop(monkeypatch):
    """CPU tensors run the oracle's round loop, never the alpha walk's
    wrappers or its plain version."""
    _, _, ta, t_atlas, o, d, t_max = _make("grate_soup", 0)
    rounds = []
    plain = intersect_mod._alpha_round
    monkeypatch.setattr(intersect_mod, "_alpha_round",
                        lambda *a, **k: (rounds.append(1), plain(*a, **k))[1])
    for name in ("woop_nearest_alpha", "woop_stream_alpha", "woop_alpha_reference",
                 "intersect_woop_alpha"):
        monkeypatch.setattr(woop, name, lambda *a, **k: pytest.fail("the alpha walk on the CPU"))
    trace_nearest(ta, t_atlas, torch.from_numpy(o), torch.from_numpy(d), 0.0,
                  torch.from_numpy(t_max))
    assert 1 < len(rounds) <= materials.MAX_INTERSECTIONS


def test_alpha_walk_rejects_bad_inputs():
    _, _, ta, t_atlas, o, d, t_max = _make("grate_soup", 0)
    n = len(o)
    args = woop.k1_inputs(ta, torch.from_numpy(o), torch.from_numpy(d), torch.zeros(n),
                          torch.from_numpy(t_max))
    tables = woop.alpha_tables(ta, t_atlas)
    out = woop.woop_nearest_alpha(*args, tables, n=n)
    _assert_same_bits(out, woop.woop_alpha_reference(args[0], args[1], tables, n=n))
    with pytest.raises(ValueError, match="counts"):
        woop.woop_nearest_alpha(*args, tables, n=n, counts=torch.zeros((4, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="n="):
        woop.woop_stream_alpha(*args, tables, n=args[0].shape[1] + 1)
    with pytest.raises(ValueError, match="texnum"):
        woop.woop_nearest_alpha(*args, tables._replace(texnum=tables.texnum.long()), n=n)
    with pytest.raises(ValueError, match="contiguous"):
        st = tables.st.transpose(1, 2).contiguous().transpose(1, 2)
        woop.woop_nearest_alpha(*args, tables._replace(st=st), n=n)
    with pytest.raises(ValueError, match="tri_attr"):
        woop.woop_nearest_alpha(*args, tables._replace(tri_attr=tables.tri_attr[:, :8]
                                                       .contiguous()), n=n)


@pytest.mark.cuda
def test_alpha_walk_matches_plain_on_card():
    """Both instances of the alpha walk on the card against the plain
    version and the eager round loop, bit for bit (chip_smoke.py phase 39
    makes this comparison on the grate soup, seven rejecting planes, the
    court's 1080p populations and the live dungeon's refreshed tables)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _, _, ta, t_atlas, o, d, t_max = _make("grate_soup", 0)
    dev = torch.device("cuda")
    ta = build_accel(ta.scene.to(dev), t_atlas.to(dev))
    n = len(o)
    args = woop.k1_inputs(ta, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                          torch.zeros(n, device=dev), torch.from_numpy(t_max).to(dev))
    tables = woop.alpha_tables(ta, t_atlas.to(dev))
    ref = woop.woop_alpha_reference(args[0], args[1], tables, n=n)
    for walk in (woop.woop_nearest_alpha, woop.woop_stream_alpha):
        _assert_same_bits(walk(*args, tables, n=n), ref)
