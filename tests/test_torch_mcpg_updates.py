"""The guided surface pass and the update replay, one step each, on state
carried over from a warmed JAX run; the save rule on forced collisions;
the live-lane compaction.

Guiding is a feedback loop: an ulp flips an accept or a reservoir pick,
and the flipped state feeds the next frame. So each twin gets IDENTICAL
inputs carried from the JAX package's run (state, gbuffer and queues
through ``interop``) and compares one step.

City at 48×27, 2 spp, max path length 3, small grids (8,192 + 512 chain
states, 4,096 light-cache cells), three jitted JAX frames, then frame 3:

- surface step (port against the jitted JAX pass): the live counts
  entering each segment, every queue row's cell and id, the light-cache
  and zero masks and the global row ids are EQUAL (read: 100% of 5,184
  rows; 2,300 live update rows); the queue's float columns differ by
  ulps (XLA fuses the multiply-adds; 99.48% of the weights within rtol
  1e-3, bound ≥ 98%); the irradiance image is within
  1e-3 on 99.07% of pixels, mean |Δ| 8.1e-4. Bounds: integers ≥ 99.5%
  equal, image ≥ 98% and < 2e-3.
- replay step on the JAX pass's own queues: the compacted queues are
  bit-equal (the light-cache rows on their live prefix); of the new
  state, ``mc.i`` (id, N, hash) equal on 100% of rows (1,478 rows
  changed), ``mc.f`` within rtol 1e-4 (read: 4.5e-6), the light cache's
  hash and N equal, its irradiance within rtol 1e-4, both counters
  equal. Bounds: ≥ 99.5% of rows equal, the rest as read.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu import renderer as j_renderer
from merian_quake_tpu.accel.build import build_accel as j_build_accel
from merian_quake_tpu.accel.build import scene_features as j_scene_features
from merian_quake_tpu.models.procedural import city as j_city
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.models.types import default_uniforms as j_default_uniforms
from merian_quake_tpu.render.gbuffer import render_gbuffer as j_render_gbuffer
from merian_quake_tpu.render.mcpg import MCPGConfig as JMCPGConfig
from merian_quake_tpu.render.mcpg import init_mcpg_state as j_init_mcpg_state
from merian_quake_tpu.render.mcpg import surface as j_surf
from merian_quake_tpu.render.mcpg import updates as j_upd
from merian_quake_tpu_torch import interop, renderer
from merian_quake_tpu_torch.accel.build import build_accel, scene_features
from merian_quake_tpu_torch.models.procedural import city
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.render.mcpg import MCPGConfig, init_mcpg_state
from merian_quake_tpu_torch.render.mcpg import surface as t_surf
from merian_quake_tpu_torch.render.mcpg import updates as t_upd

torch.set_num_threads(min(2, torch.get_num_threads()))

W, H, SPP, SEED = 48, 27, 2, 1337
KW = dict(mc_adaptive_size=1 << 13, mc_static_size=1 << 9, lc_size=1 << 12)
CFG, JCFG = MCPGConfig(**KW), JMCPGConfig(**KW)
T = torch.from_numpy


def _u64(x):
    return np.asarray(x).astype(np.int64)


class Warm:
    """Three jitted JAX frames, then frame 3's gbuffer, surface pass,
    compacted queues and replay; the port's scene and carried inputs."""

    def __init__(self):
        b = j_city()
        acc = j_build_accel(b.scene, b.atlas)
        self.jcfg = jcfg = JConfig(
            width=W, height=H, spp=SPP, max_path_length=3, integrator="mcpg", seed=SEED,
            features=j_scene_features(b.scene, b.uniforms, b.atlas),
        )
        st = j_renderer.init_state(jcfg, JCFG)
        step = jax.jit(lambda u, s: j_renderer.frame_core(acc, b.atlas, u, jcfg, s, mcpg_config=JCFG)[0])
        for i in range(3):
            st = step(b.uniforms._replace(frame=jnp.uint32(i)), st)
        self.j_state = st.mcpg
        self.j_uni = uni = b.uniforms._replace(frame=jnp.uint32(3))
        self.j_gbuf = jax.jit(lambda u: j_render_gbuffer(acc, b.atlas, u, jcfg))(uni)
        self.j_res = jax.jit(
            lambda u, m, g: j_surf.render_mcpg_surface(acc, b.atlas, u, jcfg, JCFG, m, g)
        )(uni, st.mcpg, self.j_gbuf)
        self.j_cq = jax.jit(lambda r: j_upd.compact_queues(r, JCFG, r.gidx, r.gidx))(self.j_res)
        self.j_new = jax.jit(
            lambda m, c, u: j_upd.apply_updates_compact(jnp.uint32(SEED), m, c, u, JCFG)
        )(st.mcpg, self.j_cq, uni)

        self.bundle = tb = city(device="cpu")
        self.accel = build_accel(tb.scene, tb.atlas, device="cpu")
        self.cfg = RenderConfig(
            width=W, height=H, spp=SPP, max_path_length=3, integrator="mcpg", seed=SEED,
            features=scene_features(tb.scene, tb.uniforms, tb.atlas),
        )
        self.uni = interop.uniforms_from_numpy(uni, "cpu")
        self.state = interop.mcpg_state_from_numpy(st.mcpg, "cpu")
        self.gbuf = interop.gbuffer_from_numpy(self.j_gbuf, "cpu")


@pytest.fixture(scope="module")
def warm():
    return Warm()


def test_interop_carries_the_guiding_state(warm):
    st, jst = warm.state, warm.j_state
    assert st.mc.i.dtype == torch.int32 and st.lc.hash.dtype == torch.int32
    np.testing.assert_array_equal(st.mc.i.numpy(), np.asarray(jst.mc.i))
    np.testing.assert_array_equal(st.mc.f.numpy(), np.asarray(jst.mc.f))
    np.testing.assert_array_equal(st.mc.id.numpy(), _u64(jst.mc.id))
    np.testing.assert_array_equal(st.lc.hash.numpy(), _u64(jst.lc.hash))
    assert int(st.lc_updates_applied) == int(jst.lc_updates_applied) > 0
    assert (st.mc.sum_w > 0).sum() > 100  # warmed: the chains are live
    fs = interop.frame_state_from_numpy(
        j_renderer.init_state(warm.jcfg, JCFG)._replace(mcpg=jst), "cpu")
    assert torch.equal(fs.mcpg.mc.i, st.mc.i) and fs.restir is None


def test_surface_step_on_carried_state(warm):
    res = t_surf.render_mcpg_surface(
        warm.accel, warm.bundle.atlas, warm.uni, warm.cfg, CFG, warm.state, warm.gbuf)
    jres = warm.j_res
    np.testing.assert_array_equal(res.live_in.numpy(), np.asarray(jres.live_in))
    assert res.live_in[0] == W * H * SPP and 0 < res.live_in[1] < W * H * SPP
    np.testing.assert_array_equal(res.gidx.numpy(), np.asarray(jres.gidx))
    jd, td = np.asarray(jres.updates.data), res.updates.data.numpy()
    assert td.shape == jd.shape == (2 * W * H * SPP, 15) and td.dtype == np.int32
    S = CFG.mc_total_size
    assert (jd[:, 14] < S).sum() > 1000  # live update rows to compare
    assert (td[:, 14] == jd[:, 14]).mean() >= 0.995  # cells, with the mask in them
    assert (td[:, 13] == jd[:, 13]).mean() >= 0.995 and (td[:, 13] < 0).any()  # ids, wrapped
    both = (jd[:, 14] < S) & (td[:, 14] < S)
    # floats: an ulp in a jittered light-cache cell gives a few rows
    # another weight (read: 99.48% of w within rtol 1e-3, all targets)
    close = lambda a, b, **kw: np.isclose(a.numpy()[both], np.asarray(b)[both], **kw).mean()
    assert close(res.updates.w, jres.updates.w, rtol=1e-3, atol=1e-5) >= 0.98
    assert close(res.updates.target, jres.updates.target, rtol=1e-4, atol=1e-2) >= 0.98
    assert (res.lc_samples.mask.numpy() == np.asarray(jres.lc_samples.mask)).mean() >= 0.995
    assert (res.zeros.mask.numpy() == np.asarray(jres.zeros.mask)).mean() >= 0.995
    d = np.abs(res.irradiance.numpy() - np.asarray(jres.irradiance))
    assert (d.max(-1) <= 1e-3).mean() >= 0.98 and d.mean() < 2e-3
    assert torch.isfinite(res.irradiance).all() and float(res.irradiance[..., :3].mean()) > 0.01


def test_compact_queues_on_the_jax_emission(warm):
    tr = interop.surface_result_from_numpy(warm.j_res, "cpu")
    assert torch.equal(tr.updates.id, T(_u64(warm.j_res.updates.id)))
    cq = t_upd.compact_queues(tr, CFG, tr.gidx, tr.gidx)
    np.testing.assert_array_equal(cq.upd.numpy(), np.asarray(warm.j_cq.upd))
    np.testing.assert_array_equal(cq.zeros.numpy(), np.asarray(warm.j_cq.zeros))
    jl, tl = np.asarray(warm.j_cq.lc), cq.lc.numpy()
    np.testing.assert_array_equal(tl[:, 6], jl[:, 6])
    live = jl[:, 6] >= 0
    assert live.sum() > 1000
    np.testing.assert_array_equal(tl[live], jl[live])
    # numbering the rows by layout gives the ids that rode with them
    g = t_upd.queue_gidx(tr.updates.data.shape[0], 2 * SPP, W, H, 0, H, device="cpu")
    assert torch.equal(g, tr.gidx)


def test_replay_step_on_the_jax_queues(warm):
    cq = t_upd.CompactedQueues(*[interop.tensor(x, "cpu") for x in warm.j_cq])
    new = t_upd.apply_updates_compact(SEED, warm.state, cq, warm.uni, CFG)
    jn = warm.j_new
    ji, ti = np.asarray(jn.mc.i), new.mc.i.numpy()
    changed = (ji != np.asarray(warm.j_state.mc.i)).any(-1)
    assert changed.sum() > 500
    same = (ji == ti).all(-1)
    assert same.mean() >= 0.995 and same[changed].mean() >= 0.995
    jf, tf = np.asarray(jn.mc.f), new.mc.f.numpy()
    np.testing.assert_allclose(tf[same], jf[same], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(new.lc.hash.numpy(), _u64(jn.lc.hash))
    np.testing.assert_array_equal(new.lc.N.numpy(), np.asarray(jn.lc.N))
    np.testing.assert_allclose(new.lc.irr.numpy(), np.asarray(jn.lc.irr), rtol=1e-4, atol=1e-5)
    assert int(new.lc_updates_applied) == int(jn.lc_updates_applied)
    assert int(new.lc_updates_merged) == int(jn.lc_updates_merged)
    # out of place: the carried state is as it was
    np.testing.assert_array_equal(warm.state.mc.i.numpy(), np.asarray(warm.j_state.mc.i))
    # and frame_core replays a given surface result the same way
    fs = renderer.init_state(warm.cfg, CFG, device="cpu")._replace(mcpg=warm.state)
    tr = interop.surface_result_from_numpy(warm.j_res, "cpu")
    fs2, _ = renderer.frame_core(
        warm.accel, warm.bundle.atlas, warm.uni, warm.cfg, fs, mcpg_config=CFG, _surf=tr)
    assert torch.equal(fs2.mcpg.mc.i, new.mc.i) and torch.equal(fs2.mcpg.mc.f, new.mc.f)


# ---- equal save sites ----

TINY = dict(mc_adaptive_size=16, mc_static_size=4, lc_size=64)


def _collision_queue(m=256, n_cells=20):
    r = np.random.default_rng(3)
    pos = (r.normal(size=(m, 3)) * 60.0 + [0, 0, 40]).astype(np.float32)
    nrm = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (m, 1))
    return dict(
        cell=r.integers(0, n_cells, m).astype(np.int32),
        id=r.integers(0, 2**32, m).astype(np.uint32),
        w=(r.random(m) * 3.0 + 0.1).astype(np.float32),
        target=(pos + r.normal(size=(m, 3)) * 30.0).astype(np.float32),
        mv=np.zeros((m, 3), np.float32), pos=pos, normal=nrm,
        mask=np.ones(m, bool),
    )


def _hand_result(mod, conv, q, sentinel):
    m = q["cell"].shape[0]
    z3, zb = np.zeros((m, 3), np.float32), np.zeros(m, bool)
    qq = {k: conv(v) for k, v in q.items()}
    if mod is t_surf:
        qq["id"] = T(q["id"].astype(np.int64))
    return mod.SurfaceResult(
        irradiance=conv(np.zeros((1, 1, 4), np.float32)),
        updates=mod.UpdateQueue.build(sentinel=sentinel, **qq),
        lc_samples=mod.LCQueue(pos=conv(z3), normal=conv(z3), irr=conv(z3), mask=conv(zb)),
        zeros=mod.ZeroQueue(cell=conv(np.zeros(m, np.int32)), mask=conv(zb)),
    )


@pytest.mark.parametrize("key", [1, 2, 3])
def test_equal_save_sites_last_in_cell_order_writes_both_tables(key):
    """20 touched cells save into 4 static and 16 adaptive sites: many
    winners share a site. Among the rows that replace at one site the
    last in cell order writes ``f`` AND ``i``: every saved state holds
    the id and the target of one winner, and the tables equal the JAX
    package's, whose scatter applies its rows in order on the CPU."""
    cfg, jcfg = MCPGConfig(**TINY), JMCPGConfig(**TINY)
    q = _collision_queue()
    uni = j_default_uniforms(cl_time=1.0)
    st = t_upd.apply_updates(
        key, init_mcpg_state(cfg, device="cpu"), _hand_result(t_surf, T, q, cfg.mc_total_size),
        interop.uniforms_from_numpy(uni, "cpu"), cfg)
    jst = j_upd.apply_updates(
        jnp.uint32(key), j_init_mcpg_state(jcfg), _hand_result(j_surf, jnp.asarray, q, cfg.mc_total_size),
        uni, jcfg)
    np.testing.assert_array_equal(st.mc.i.numpy(), np.asarray(jst.mc.i))
    np.testing.assert_allclose(st.mc.f.numpy(), np.asarray(jst.mc.f), rtol=1e-5, atol=1e-6)
    live = st.mc.sum_w > 0
    assert live.sum() >= 10  # the sites filled up: collisions were there
    # fresh chains: a winner's row is w·target, w, w — id and floats of
    # one sample, found together in the queue
    ids, f = st.mc.id[live].numpy(), st.mc.f[live].numpy()
    for sid, row in zip(ids, f):
        src = np.where(q["id"] == sid)[0]
        assert len(src) == 1
        np.testing.assert_allclose(row[3], q["w"][src[0]], rtol=1e-6)
        np.testing.assert_allclose(row[0:3], q["w"][src[0]] * q["target"][src[0]], rtol=1e-5)


def test_save_rule_does_not_depend_on_scatter_order(monkeypatch):
    """The rule is made explicit before the scatter: with the rows of
    every table write reversed, the state is the same."""
    from merian_quake_tpu_torch.ops import segments

    cfg = MCPGConfig(**TINY)
    q = _collision_queue()
    uni = interop.uniforms_from_numpy(j_default_uniforms(cl_time=1.0), "cpu")
    run = lambda: t_upd.apply_updates(
        2, init_mcpg_state(cfg, device="cpu"), _hand_result(t_surf, T, q, cfg.mc_total_size), uni, cfg)
    want = run()
    plain = segments.scatter_rows

    def reversed_rows(table, idx, rows):
        if isinstance(rows, torch.Tensor) and rows.dim() > 0:
            return plain(table, idx.flip(0), rows.flip(0))
        return plain(table, idx, rows)

    monkeypatch.setattr(segments, "scatter_rows", reversed_rows)
    got = run()
    assert torch.equal(got.mc.i, want.mc.i) and torch.equal(got.mc.f, want.mc.f)


# ---- live-lane compaction ----


def test_surface_live_compaction_exact(warm, monkeypatch):
    """A budgeted segment sorts lanes live-first and runs the body on the
    static prefix only: per-lane RNG streams and math are permutation
    invariant, and eager PyTorch computes each lane alike at any width,
    so the image is equal bit for bit (the JAX package allows 1% of
    pixels to differ, since XLA fuses each width its own way). Both
    branches run: compacted, and overflow → full width."""
    monkeypatch.setattr(t_surf, "COMPACT_MIN_NS", 0)
    run = lambda mcfg: t_surf.render_mcpg_surface(
        warm.accel, warm.bundle.atlas, warm.uni, warm.cfg, mcfg, warm.state, warm.gbuf)
    base = run(CFG)
    ns = W * H * SPP
    assert base.live_in[1] / ns < 0.5  # bounce-1 deaths: compaction has room
    assert t_surf._seg_budgets(CFG._replace(surf_live_budget=(1.0, 0.5)), 2, ns) == [ns, 2048]
    # (1.0, 0.4): segment 1 runs COMPACTED (592 live lanes in 2 blocks of
    # 1024); (0.5, 0.14): segment 0 overflows its 2048 lanes → full-width
    # fallback on sorted lanes, segment 1 compacted into one block
    for buds, widths in [((1.0, 0.4), (ns, 2048)), ((0.5, 0.14), (2048, 1024))]:
        mc2 = CFG._replace(surf_live_budget=buds)
        assert tuple(t_surf._seg_budgets(mc2, 2, ns)) == widths
        res = run(mc2)
        assert torch.equal(res.irradiance, base.irradiance), buds
        assert torch.equal(res.live_in, base.live_in)
        # the same live queue rows under the same global ids, in lane order
        S = CFG.mc_total_size
        for r in (res, base):
            live = r.updates.cell < S
            order = torch.argsort(r.gidx[live])
            r_rows = torch.cat([r.updates.data[live], r.gidx[live][:, None]], 1)[order]
            if r is res:
                got = r_rows
        assert torch.equal(got, r_rows), buds
    assert int(base.live_in[1]) <= 1024 and int(base.live_in[0]) > 2048


def test_frame_core_budget_queue_slice(warm, monkeypatch):
    """frame_core with live-lane budgets: the statically-dead queue
    padding is sliced off before the update replay, and the guiding
    state comes out as without budgets (no live row lies past a budget
    that did not overflow)."""
    monkeypatch.setattr(t_surf, "COMPACT_MIN_NS", 0)
    fs = renderer.init_state(warm.cfg, CFG, device="cpu")._replace(mcpg=warm.state)
    args = (warm.accel, warm.bundle.atlas, warm.uni, warm.cfg, fs)
    base, out0 = renderer.render_frame(*args, CFG)
    mc2 = CFG._replace(surf_live_budget=(1.0, 0.4))
    seen = []
    plain = t_upd.compact_queues
    monkeypatch.setattr(t_upd, "compact_queues", lambda r, *a, **k: seen.append(r) or plain(r, *a, **k))
    state, out = renderer.render_frame(*args, mc2)
    assert seen[0].updates.data.shape[0] == W * H * SPP + 2048  # Σ budgets rows
    assert torch.isfinite(out["ldr"]).all() and torch.equal(out["ldr"], out0["ldr"])
    assert torch.isfinite(state.mcpg.mc.f).all() and float(state.mcpg.mc.sum_w.max()) > 0.0
    assert torch.equal(state.mcpg.mc.i, base.mcpg.mc.i)
    assert torch.equal(state.mcpg.lc.N, base.mcpg.lc.N)


# ---- the same two on the outdoor court (tests/test_mcpg.py:329, :380) ----


def _court(w, h):
    from merian_quake_tpu_torch.models.procedural import outdoor_court

    tb = outdoor_court(device="cpu")
    accel = build_accel(tb.scene, tb.atlas, device="cpu")
    cfg = RenderConfig(width=w, height=h, spp=1, max_path_length=3, integrator="mcpg",
                       features=scene_features(tb.scene, tb.uniforms, tb.atlas))
    mcfg = MCPGConfig(mc_adaptive_size=1 << 12, mc_static_size=1 << 10, lc_size=1 << 10)
    return tb, accel, cfg, mcfg


def test_surface_live_compaction_exact_court(monkeypatch):
    """The court at 112×64 from an empty state, as the JAX package's test:
    both branches (compacted, and overflow → full width) give the
    uncompacted image bit for bit and the same live counts."""
    from merian_quake_tpu_torch.render.gbuffer import render_gbuffer

    monkeypatch.setattr(t_surf, "COMPACT_MIN_NS", 0)
    tb, accel, cfg, mcfg = _court(112, 64)
    state = init_mcpg_state(mcfg, device="cpu")
    gbuf = render_gbuffer(accel, tb.atlas, tb.uniforms, cfg)
    run = lambda m: t_surf.render_mcpg_surface(accel, tb.atlas, tb.uniforms, cfg, m, state, gbuf)
    base = run(mcfg)
    live_frac = base.live_in.numpy() / (112 * 64)
    assert live_frac[1] < 0.5  # bounce-1 deaths: compaction has room
    # (1.0, 0.5): segment 1 runs compacted; (0.5, 0.14): both overflow
    for buds in [(1.0, 0.5), (0.5, 0.14)]:
        res = run(mcfg._replace(surf_live_budget=buds))
        assert torch.equal(res.irradiance, base.irradiance), buds
        assert torch.equal(res.live_in, base.live_in), buds


def test_frame_core_budget_queue_slice_court(monkeypatch):
    """frame_core on the court at 64×40 with budgets (1.0, 0.5): the dead
    queue padding is sliced off, the frame is finite, guiding learns, and
    the state equals the frame's without budgets."""
    monkeypatch.setattr(t_surf, "COMPACT_MIN_NS", 0)
    tb, accel, cfg, mcfg = _court(64, 40)
    uni = tb.uniforms._replace(frame=3)
    base, out0 = renderer.render_frame(accel, tb.atlas, uni, cfg,
                                       renderer.init_state(cfg, mcfg, device="cpu"), mcfg)
    mc2 = mcfg._replace(surf_live_budget=(1.0, 0.5))
    state, out = renderer.render_frame(accel, tb.atlas, uni, cfg,
                                       renderer.init_state(cfg, mc2, device="cpu"), mc2)
    assert torch.isfinite(out["ldr"]).all() and torch.isfinite(state.mcpg.mc.f).all()
    assert float(state.mcpg.mc.sum_w.max()) > 0.0  # the queue slice kept live rows
    assert torch.equal(out["ldr"], out0["ldr"]) and torch.equal(state.mcpg.mc.i, base.mcpg.mc.i)
