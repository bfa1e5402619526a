"""The live game loop's accel, port against the JAX package.

The same game (each package's native host, which step bit for bit alike:
tests/test_torch_game.py) feeds ``build_accel_live`` + ``refresh_dynamic``
of both packages; the port's tables must equal those of the JAX
package's ``_apply_dyn_jit``, table by table. The port writes the
dynamic suffix in place, so what the card's tracers keep from a table
(the packed rows ``rows4``, the padded bounds and the node and cluster
boxes, K8's triangle table) must be made anew on every refresh: the
invariant tests hold that, and mutants that write in place without it
fail them. ``tests/test_live.py::test_live_accel_matches_full_build``
is held on the CPU oracle, and one live dungeon frame (PT, mpl 2, and
MCPG) of the port, fed the JAX package's live tables through
``interop.live_accel_from_numpy``, is held to the JAX package's frame
within tests/test_torch_slice.py's bound, eagerly and through
``renderer.compile_frame``. The refresh rewrites the derived tables in
place, so each keeps its storage (a captured frame holds its address):
the invariant test checks that after every refresh, and a mutant that
drops them to be made anew fails it. A compiled live step
(refresh, then the compiled frame) over moving frames of the arena,
recorded once and fed to two live accels, equals the eager step bit for
bit. The card's side (K1, K2, K3 on refreshed tables, the rows4 mutant;
the captured live dungeon and arena against eager, the stale-cache
mutant) is chip_smoke's phases 30-31.
"""
import jax
import numpy as np
import pytest
import torch

from merian_quake_tpu.accel.build import build_accel_live as j_build_accel_live
from merian_quake_tpu.accel.build import refresh_dynamic as j_refresh_dynamic
from merian_quake_tpu.game.bigmap import make_bigmap as j_make_bigmap
from merian_quake_tpu.game.mod import make_arena as j_make_arena
from merian_quake_tpu_torch import capture, interop
from merian_quake_tpu_torch.accel import build, dense, woop
from merian_quake_tpu_torch.accel.build import build_accel, build_accel_live, refresh_dynamic
from merian_quake_tpu_torch.accel.intersect import trace_nearest
from merian_quake_tpu_torch.game.bigmap import make_bigmap
from merian_quake_tpu_torch.game.mod import make_arena

torch.set_num_threads(min(2, torch.get_num_threads()))

STEPS = 3
# the K3 walk's node and sub-node sizes (csrc/woop_walk.cuh kNode/kSub)
NODE, SUB = 64, 8
# the Woop tables of a live accel: (table, its cluster bounds)
TABLES = (("woop_w", "cluster_lo", "cluster_hi"),
          ("woop_w_shadow", "cluster_lo", "cluster_hi"),
          ("woop_w_alpha", "cluster_lo_alpha", "cluster_hi_alpha"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _step(live, i):
    return live.step_dynamic(dt=1 / 30, forward=100.0, yaw=15.0 + 7.0 * i, attack=i == 1)


@pytest.fixture(scope="module")
def arenas():
    """Both packages' arenas and live accels after STEPS moving steps."""
    j, t = j_make_arena(dynamic_capacity=512), make_arena(dynamic_capacity=512, device="cpu")
    j_la = j_build_accel_live(j.gs.static_bundle, dyn_cap=512)
    t_la = build_accel_live(t.gs.static_bundle, dyn_cap=512, device="cpu")
    for i in range(STEPS):
        j_dyn, _ = _step(j, i)
        t_dyn, _ = _step(t, i)
        j_la = j_refresh_dynamic(j_la, j_dyn)
        t_la = refresh_dynamic(t_la, t_dyn)
    return j, t, j_la, t_la, j_dyn, t_dyn


def test_extract_dynamic_matches_jax(arenas):
    _, _, _, _, j_dyn, t_dyn = arenas
    assert set(j_dyn) == set(t_dyn) and int(t_dyn["valid"].sum()) > 0
    for k in j_dyn:
        np.testing.assert_array_equal(t_dyn[k], j_dyn[k], err_msg=k)


SCENE_FIELDS = ("v0", "v1", "v2", "pv0", "pv1", "pv2", "st", "texnum", "fb_texnum",
                "normal_texnum", "gloss_texnum", "flags", "alpha", "solid_albedo",
                "solid_emission", "valid")
EXACT = ("candidate", "needs_alpha", "cluster_lo", "cluster_hi", "cluster_lo_alpha",
         "cluster_hi_alpha", "world_lo", "world_hi")


@pytest.mark.parametrize("field", SCENE_FIELDS + EXACT + ("tri_attr", "woop_w", "woop_w_shadow",
                                                          "woop_w_alpha"))
def test_refresh_tables_match_apply_dyn_jit(arenas, field):
    """Each table of the port's refreshed live accel against the JAX
    package's ``_apply_dyn_jit`` output: the static prefix as
    tests/test_torch_accel.py holds build_accel's (the Woop rows to the
    f32 rounding of two float64 inversions), the dynamic suffix bit for
    bit (both are the same numpy)."""
    _, _, j_la, t_la, _, _ = arenas
    assert (t_la.n_static, t_la.dyn_cap) == (j_la.n_static, j_la.dyn_cap)
    src = "scene" if field in SCENE_FIELDS else None
    ours = _np(getattr(t_la.accel.scene if src else t_la.accel, field))
    ref = np.asarray(getattr(j_la.accel.scene if src else j_la.accel, field))
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    rows = 3 * t_la.n_static if field.startswith("woop_w") else t_la.n_static
    if field.startswith("cluster_"):
        rows = t_la.n_static // 64
    if field.startswith("woop_w"):
        np.testing.assert_allclose(ours[:rows], ref[:rows], rtol=1e-6,
                                   atol=1e-6 * max(np.abs(ref).max(), 1.0))
        np.testing.assert_array_equal(ours[rows:], ref[rows:])
    elif field == "tri_attr":
        np.testing.assert_allclose(ours[:rows], ref[:rows], rtol=1e-6)
        np.testing.assert_array_equal(ours[rows:], ref[rows:])
    else:
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(t_la.tex_alpha, j_la.tex_alpha)
    np.testing.assert_array_equal(t_la.tex_px, j_la.tex_px)


def _fresh_caches(acc):
    """What the tracers keep on the tables, as a trace makes it (the cache)
    and as a fresh computation on copies of the same tables."""
    got = {}
    for name, lo_name, hi_name in TABLES:
        w, lo, hi = getattr(acc, name), getattr(acc, lo_name), getattr(acc, hi_name)
        plo, phi = woop.padded_bounds(lo, hi)
        flo, fhi = (x.contiguous() for x in woop._pad_bounds(lo.clone(), hi.clone()))
        got[name] = {
            "rows4": (woop.packed_rows(w), w[:, :4]),
            "padded_lo": (plo, flo), "padded_hi": (phi, fhi),
            "walk_boxes": (woop.walk_boxes(plo, phi, NODE, SUB),
                           woop.walk_boxes(flo.clone(), fhi.clone(), NODE, SUB)),
        }
    got["mt_table"] = {"mt_table": (dense.scene_table(acc), dense.mt_table(dense.pack_tris(
        acc.scene.v0.clone(), acc.scene.v1, acc.scene.v2, acc.candidate)))}
    return got


def _derived(acc) -> dict:
    """Every tensor the tracers keep on the live accel's tables, by name
    (the padded bounds, the walk boxes on them, K8's table)."""
    got = {}
    for table, pairs in _fresh_caches(acc).items():
        for key, (cached, _) in pairs.items():
            if key != "rows4":
                got[f"{table}.{key}"] = cached
    return got


def _refreshed(live, la, steps, check=None):
    """``la`` with its caches made (as a trace makes them), then ``steps``
    more moving steps refreshed in; ``check(la)`` after each."""
    _fresh_caches(la.accel)
    for i in range(steps):
        dyn, _ = _step(live, 10 + i)
        la = refresh_dynamic(la, dyn)
        if check is not None:
            check(la)
    return la


def _invariants(acc):
    bad = []
    for table, pairs in _fresh_caches(acc).items():
        for key, (cached, fresh) in pairs.items():
            if not torch.equal(cached, fresh):
                bad.append(f"{table}.{key}")
    return bad


def _moved(acc, before) -> list:
    """The derived tensors whose storage is not that of the same tensor in
    ``before`` (which holds them, so that their storage is not reused)."""
    return [k for k, x in _derived(acc).items() if x.data_ptr() != before[k].data_ptr()]


def test_refresh_invariants():
    """After each of several refreshes: every table's packed rows equal
    its columns 0-3, the cached padded bounds, walk boxes and K8 table
    equal a fresh computation, and each of them keeps the storage it had
    before the first refresh (a captured frame holds their addresses), as
    every table does; no two Woop tables share storage (the static arena
    has neither sky nor alpha, so build_accel's shadow table is woop_w
    itself and it has no alpha table)."""
    live = make_arena(dynamic_capacity=256, device="cpu")
    static = build_accel(live.gs.static_bundle.scene, live.gs.static_bundle.atlas)
    assert static.woop_w_shadow is static.woop_w and static.woop_w_alpha is None
    la = build_accel_live(live.gs.static_bundle, dyn_cap=256, device="cpu")
    ptrs = {name: getattr(la.accel, name).data_ptr() for name, _, _ in TABLES}
    assert len(set(ptrs.values())) == 3
    derived = _derived(la.accel)
    # woop_w and the shadow table share their bounds, so their caches too
    assert len(derived) == 10 and len({x.data_ptr() for x in derived.values()}) == 7
    seen = []

    def check(la):
        assert _invariants(la.accel) == []
        assert _moved(la.accel, derived) == []
        seen.append(int(la.accel.scene.valid[la.n_static:].sum()))

    la = _refreshed(live, la, 3, check)
    assert len(seen) == 3 and min(seen) > 0
    assert {name: getattr(la.accel, name).data_ptr() for name, _, _ in TABLES} == ptrs


@pytest.mark.parametrize("mutant", ["rows4", "caches", "drop"])
def test_refresh_mutants_fail_the_invariants(monkeypatch, mutant):
    """A refresh that writes in place but leaves the packed rows, or the
    kept bounds and boxes, as they were fails the invariants; one that
    drops the kept tables where it should rewrite them (what the refresh
    did before a frame could be captured on them) makes them anew in new
    storage, which a captured frame would never read: it fails the storage
    check."""
    live = make_arena(dynamic_capacity=256, device="cpu")
    la = build_accel_live(live.gs.static_bundle, dyn_cap=256, device="cpu")
    if mutant == "rows4":
        monkeypatch.setattr(build, "_write_table", build._write)
    elif mutant == "caches":
        monkeypatch.setattr(woop, "rewrite_cached", lambda owner: None)
    else:  # the refresh before the derived tables were rewritten in place
        monkeypatch.setattr(woop, "rewrite_cached", lambda owner: owner.__dict__.pop("_mq_cache", None))
    derived = _derived(la.accel)
    la = _refreshed(live, la, 3)
    bad = _invariants(la.accel)
    if mutant == "rows4":
        assert bad == ["woop_w.rows4", "woop_w_shadow.rows4"], bad
    elif mutant == "caches":
        assert {"woop_w.padded_lo", "woop_w.walk_boxes", "mt_table.mt_table"} <= set(bad), bad
    else:
        assert bad == [] and set(_moved(la.accel, derived)) == set(derived)


LIVE_W, LIVE_H, LIVE_FRAMES = 32, 16, 4


def _live_steps(integ, compiled, recording, frames_out):
    """The arena's live step over ``recording`` (each frame's (dyn,
    uniforms)) on a live accel of its own: refresh, then the eager frame
    or the compiled one; each frame's (state, outputs) cloned into
    ``frames_out``."""
    from merian_quake_tpu_torch.cli import live_features
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.restir import ReSTIRConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.renderer import compile_frame, frame_core, init_state

    live, bundle = recording["live"], recording["live"].gs.static_bundle
    cfg = RenderConfig(width=LIVE_W, height=LIVE_H, spp=1, integrator=integ,
                       features=live_features(bundle))
    icfg = MCPGConfig() if integ == "mcpg" else ReSTIRConfig()
    la = build_accel_live(bundle, dyn_cap=live.gs.dynamic_capacity, device="cpu")
    state, step = init_state(cfg, icfg, device="cpu"), None
    for dyn, u in recording["frames"]:
        la = refresh_dynamic(la, dyn)
        if compiled:
            step = step or compile_frame(la.accel, bundle.atlas, cfg, state, icfg)
            state, out = step(u)
        else:
            state, out = frame_core(la.accel, bundle.atlas, u, cfg, state, mcpg_config=icfg)
        frames_out.append(capture.tree_map(torch.clone, (state, out)))


@pytest.fixture(scope="module")
def arena_recording():
    """The arena's (dyn, uniforms) for LIVE_FRAMES moving frames, recorded
    once (the player walks and turns, fires in frame 1)."""
    live = make_arena(dynamic_capacity=512, device="cpu")
    return {"live": live, "frames": [_step(live, i) for i in range(LIVE_FRAMES)]}


@pytest.mark.parametrize("integ", ["mcpg", "restir"])
def test_compiled_live_step_equals_eager(arena_recording, integ):
    """The compiled live step (refresh, then the compiled frame, as cli
    play runs it) equals the eager one bit for bit on every frame, state
    and outputs, while the entities move."""
    eager, compiled = [], []
    _live_steps(integ, False, arena_recording, eager)
    _live_steps(integ, True, arena_recording, compiled)
    dyn = [d["v"] for d, _ in arena_recording["frames"]]
    assert any(not np.array_equal(a, b) for a, b in zip(dyn, dyn[1:]))  # the entities move
    assert len(eager) == len(compiled) == LIVE_FRAMES
    for (es, eo), (cs, co) in zip(eager, compiled):
        assert capture.skeleton(es) == capture.skeleton(cs)
        for a, b in zip(capture.tree_leaves((es, eo)), capture.tree_leaves((cs, co))):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_captured_live_loop_equals_eager_on_the_card():
    """The live dungeon (K3) and the arena's MCPG and ReSTIR frames
    captured against eager on the card over 10 moving frames, the
    stale-cache mutant differing: the card's machine has no JAX, so
    chip_smoke phases 30-31 make these comparisons."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    live = make_arena(dynamic_capacity=512, device="cuda")
    la = build_accel_live(live.gs.static_bundle, dyn_cap=512, device="cuda")
    derived = _derived(la.accel)
    la = refresh_dynamic(la, _step(live, 0)[0])
    assert _moved(la.accel, derived) == []


def test_live_accel_matches_full_build():
    """tests/test_live.py's test on the CPU oracle: the incremental accel
    traces as a from-scratch build_accel of the same frame's full scene,
    hit/miss equal and t within its tolerance."""
    live = make_arena(dynamic_capacity=512, device="cpu")
    la = build_accel_live(live.gs.static_bundle, dyn_cap=live.gs.dynamic_capacity, device="cpu")
    for i in range(3):
        dyn, _ = live.step_dynamic(dt=1 / 30, forward=60.0, yaw=10.0)
    la = refresh_dynamic(la, dyn)
    scene, _ = live.gs.extract()
    acc_full = build_accel(scene, live.gs.static_bundle.atlas)
    rng = np.random.default_rng(7)
    n = 256
    o = torch.full((n, 3), 0.0) + torch.tensor([256.0, 256.0, 120.0])
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    h_live = trace_nearest(la.accel, None, o, d, 0.0, 1e4)
    h_full = trace_nearest(acc_full, None, o, d, 0.0, 1e4)
    np.testing.assert_array_equal(h_live.hit.numpy(), h_full.hit.numpy())
    hit = h_full.hit.numpy()
    np.testing.assert_allclose(h_live.t.numpy()[hit], h_full.t.numpy()[hit], rtol=1e-5, atol=1e-3)
    # rays aimed at the live entities hit them on both
    dyn_tris = la.accel.scene.valid[la.n_static:].nonzero()[:, 0] + la.n_static
    c = (la.accel.scene.v0[dyn_tris] + la.accel.scene.v1[dyn_tris] + la.accel.scene.v2[dyn_tris]) / 3
    o2 = torch.tensor([[256.0, 256.0, 120.0]]).expand_as(c).contiguous()
    d2 = c - o2
    d2 = d2 / torch.linalg.vector_norm(d2, dim=1, keepdim=True)
    a = trace_nearest(la.accel, None, o2, d2, 0.0, 1e4)
    b = trace_nearest(acc_full, None, o2, d2, 0.0, 1e4)
    np.testing.assert_array_equal(a.hit.numpy(), b.hit.numpy())
    np.testing.assert_allclose(a.t.numpy(), b.t.numpy(), rtol=1e-5, atol=1e-3)
    assert bool((a.tri >= la.n_static).any())


# ------------------------------------------------------------ a live frame

W, H = 64, 40


@pytest.fixture(scope="module")
def dungeon_frames():
    """The live dungeon (grid 3, 4 monsters) after 3 steps in both
    packages; PT (mpl 2) and MCPG frames of the JAX package on its live
    tables and of the port on the same tables, carried across."""
    from merian_quake_tpu.accel.build import scene_features as j_scene_features
    from merian_quake_tpu.models.types import RenderConfig as JConfig
    from merian_quake_tpu.renderer import init_state as j_init_state
    from merian_quake_tpu.renderer import render_frame as j_render_frame
    from merian_quake_tpu.render.mcpg import MCPGConfig as JMCPGConfig
    from merian_quake_tpu_torch.cli import live_features
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.renderer import compile_frame, init_state, render_frame

    j, _ = j_make_bigmap(grid=3, monsters=4, dynamic_capacity=512)
    t, _ = make_bigmap(grid=3, monsters=4, dynamic_capacity=512, device="cpu")
    j_la = j_build_accel_live(j.gs.static_bundle, dyn_cap=512)
    for i in range(3):
        j_dyn, j_u = j.step_dynamic(dt=1 / 30, forward=100.0, yaw=15.0 + i)
        t_dyn, t_u = t.step_dynamic(dt=1 / 30, forward=100.0, yaw=15.0 + i)
        j_la = j_refresh_dynamic(j_la, j_dyn)
    jb = j.gs.static_bundle
    j_feats = j_scene_features(jb.scene, jb.uniforms, jb.atlas)._replace(
        has_alpha_tris=True, has_fb=True, has_emissive_tex=True)
    t_feats = live_features(t.gs.static_bundle)
    assert tuple(t_feats) == tuple(j_feats)
    la = interop.live_accel_from_numpy(j_la, device="cpu")
    atlas = interop.atlas_from_numpy(jb.atlas, device="cpu")
    out = {}
    for integ, mpl in (("pt", 2), ("mcpg", 3)):
        jc = JConfig(width=W, height=H, spp=1, max_path_length=mpl, integrator=integ,
                     features=j_feats)
        j_mcfg = JMCPGConfig() if integ == "mcpg" else None
        _, j_out = j_render_frame(j_la.accel, jb.atlas, j_u, jc, j_init_state(jc, j_mcfg), j_mcfg)
        jax.block_until_ready(j_out["ldr"])
        tc = RenderConfig(width=W, height=H, spp=1, max_path_length=mpl, integrator=integ,
                          features=t_feats)
        mcfg = MCPGConfig() if integ == "mcpg" else None
        render = lambda acc, tc=tc, mcfg=mcfg: render_frame(
            acc, atlas, t_u, tc, init_state(tc, mcfg, device="cpu"), mcfg)[1]
        compiled = compile_frame(la.accel, atlas, tc, init_state(tc, mcfg, device="cpu"),
                                 mcfg)(t_u)[1]
        out[integ] = (np.asarray(j_out["ldr"]), render(la.accel), render, compiled)
    return out, la, t_dyn, j_dyn, t_u, j_u


def _ldr_agrees(ours, ref):
    d = np.abs(ours.numpy() - ref)
    share = (d.max(-1) <= 1e-3).mean()
    return bool(share >= 0.995 and d.mean() < 1e-4), share, d.mean()


@pytest.mark.parametrize("integ", ["pt", "mcpg"])
def test_live_frame_matches_jax(dungeon_frames, integ):
    out, la, t_dyn, j_dyn, t_u, j_u = dungeon_frames
    for k in j_dyn:
        np.testing.assert_array_equal(t_dyn[k], j_dyn[k], err_msg=k)
    for f in ("cam_x", "cam_w", "cam_u", "prev_cam_x", "cl_time", "time_diff"):
        np.testing.assert_array_equal(_np(getattr(t_u, f)), np.asarray(getattr(j_u, f)))
    assert t_u.frame == int(j_u.frame)
    ref, ours, _, _ = out[integ]
    ok, share, mean = _ldr_agrees(ours["ldr"], ref)
    assert ok, (share, mean)
    assert float(ours["ldr"].max()) > 0.01


@pytest.mark.parametrize("integ", ["pt", "mcpg"])
def test_compiled_live_frame_matches_jax(dungeon_frames, integ):
    """The same frame through compile_frame (the alpha loop's test on the
    device; live_features forces the alpha loop): the eager frame's bits,
    so the JAX package's frame within the same bound."""
    out, *_ = dungeon_frames
    ref, ours, _, compiled = out[integ]
    for k in ours:
        for a, b in zip(capture.tree_leaves(ours[k]), capture.tree_leaves(compiled[k])):
            assert torch.equal(a, b), k
    ok, share, mean = _ldr_agrees(compiled["ldr"], ref)
    assert ok, (share, mean)


def test_live_frame_mutant_fails(dungeon_frames):
    """The frame's dynamic suffix left out (the entities' triangles not
    candidates): the PT frame falls outside the bound."""
    out, la, *_ = dungeon_frames
    ref, _, render, _ = out["pt"]
    cand = la.accel.candidate.clone()
    cand[la.n_static:] = False
    ok, share, mean = _ldr_agrees(render(la.accel._replace(candidate=cand))["ldr"], ref)
    assert not ok, (share, mean)
