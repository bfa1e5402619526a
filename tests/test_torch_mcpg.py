"""The MCPG guiding machinery: port against JAX package, same numpy inputs.

Twins of tests/test_mcpg.py's unit tests (grids, the packed draw table,
vMF lobes, the light cache, the update replay on queues built by hand),
each run through both packages. Integer results (slots, verification
hashes, ids, N, the light cache's hashes and counts) are held equal;
floats to f32 rounding (rtol 1e-5 unless said).

The float → integer stages (``adaptive_target_level``, the stochastic
level, ``_lc_level``, the cell selection) are given the same 200,000
float inputs. Read against the JAX package run op by op, as these tests
run it: 100% equal slots and hashes in every stage. Against its jitted
run (XLA fuses the multiply-adds): 99.9945% of adaptive slots. Bound:
≥ 99.9%.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.models.types import default_uniforms as j_default_uniforms
from merian_quake_tpu.ops import rng as j_rng
from merian_quake_tpu.render.mcpg import MCPGConfig as JMCPGConfig
from merian_quake_tpu.render.mcpg import grids as j_grids
from merian_quake_tpu.render.mcpg import init_mcpg_state as j_init_mcpg_state
from merian_quake_tpu.render.mcpg import light_cache as j_lc
from merian_quake_tpu.render.mcpg import surface as j_surf
from merian_quake_tpu.render.mcpg.config import MCStates as JMCStates
from merian_quake_tpu.render.mcpg.updates import apply_updates as j_apply_updates
from merian_quake_tpu_torch import interop
from merian_quake_tpu_torch.ops import rng as t_rng
from merian_quake_tpu_torch.render.mcpg import MCPGConfig, grids, init_mcpg_state
from merian_quake_tpu_torch.render.mcpg import light_cache as t_lc
from merian_quake_tpu_torch.render.mcpg.config import MCStates
from merian_quake_tpu_torch.render.mcpg import surface as t_surf
from merian_quake_tpu_torch.render.mcpg.surface import UpdateQueue
from merian_quake_tpu_torch.render.mcpg.updates import apply_updates

torch.set_num_threads(min(2, torch.get_num_threads()))

KW = dict(mc_adaptive_size=1 << 12, mc_static_size=1 << 10, lc_size=1 << 12)
CFG, JCFG = MCPGConfig(**KW), JMCPGConfig(**KW)
T = torch.from_numpy


def _rngs(n, seed=1):
    return (
        j_rng.seed_pixel(jnp.arange(n, dtype=jnp.uint32), 0, 0, seed),
        t_rng.seed_pixel(torch.arange(n), 0, 0, seed),
    )


def _u64(x):
    return np.asarray(x).astype(np.int64)


def _cloud(n, seed=0):
    r = np.random.default_rng(seed)
    pos = (r.normal(size=(n, 3)) * 400.0).astype(np.float32)
    nrm = r.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pos, nrm, np.asarray([10.0, 20.0, 30.0], np.float32)


def test_config_fields_and_defaults_match():
    assert MCPGConfig._fields == JMCPGConfig._fields
    assert tuple(MCPGConfig()) == tuple(JMCPGConfig())
    assert MCPGConfig().mc_total_size == JMCPGConfig().mc_total_size == 147456
    st, jst = init_mcpg_state(CFG, device="cpu"), j_init_mcpg_state(JCFG)
    assert st.mc.f.shape == jst.mc.f.shape and st.mc.i.shape == jst.mc.i.shape
    assert st.lc.irr.shape == jst.lc.irr.shape and st.lc_updates_applied.dim() == 0


def test_adaptive_cell_locality_and_determinism():
    cam = np.zeros(3, np.float32)
    pos = np.full((64, 3), [100.0, 50.0, 20.0], np.float32)
    nrm = np.full((64, 3), [0.0, 0.0, 1.0], np.float32)
    jr, tr = _rngs(64)
    r1, buf1, h1 = grids.adaptive_cell(tr, T(pos), T(nrm), T(cam), CFG)
    _, buf2, _ = grids.adaptive_cell(tr, T(pos), T(nrm), T(cam), CFG)
    assert torch.equal(buf1, buf2)
    assert len(np.unique(buf1.numpy())) > 1
    assert buf1.max() < CFG.mc_adaptive_size
    jr1, jbuf, jh = j_grids.adaptive_cell(jr, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(cam), JCFG)
    np.testing.assert_array_equal(buf1.numpy(), _u64(jbuf))
    np.testing.assert_array_equal(h1.numpy(), _u64(jh))
    np.testing.assert_array_equal(r1.numpy(), _u64(jr1))  # the stream moved as far


def test_static_cell_offset_range():
    pos = np.full((16, 3), [100.0, 50.0, 20.0], np.float32)
    jr, tr = _rngs(16)
    _, buf, h = grids.static_cell(tr, T(pos), CFG)
    b = buf.numpy()
    assert (b >= CFG.mc_adaptive_size).all() and (b < CFG.mc_total_size).all()
    _, jbuf, jh = j_grids.static_cell(jr, jnp.asarray(pos), JCFG)
    np.testing.assert_array_equal(b, _u64(jbuf))
    np.testing.assert_array_equal(h.numpy(), _u64(jh))


@pytest.mark.parametrize("cfg_kw", [{}, {"grid_tile_bits": 1}])
def test_float_to_integer_stages_share_of_equal_cells(cfg_kw):
    n = 200000
    cfg, jcfg = CFG._replace(**cfg_kw), JCFG._replace(**cfg_kw)
    pos, nrm, cam = _cloud(n)
    jr, tr = _rngs(n)
    jp, jn, jc = jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(cam)
    share = lambda a, b: (a.numpy() == _u64(b)).mean()

    lvl = grids.adaptive_target_level(T(pos), T(cam), cfg)
    assert share(lvl, j_grids.adaptive_target_level(jp, jc, jcfg)) >= 0.999
    assert lvl.min() >= 0 and lvl.max() > 20

    _, buf, h = grids.adaptive_cell(tr, T(pos), T(nrm), T(cam), cfg)
    _, jbuf, jh = j_grids.adaptive_cell(jr, jp, jn, jc, jcfg)
    assert share(buf, jbuf) >= 0.999 and share(h, jh) >= 0.999

    _, buf, h = grids.static_cell(tr, T(pos), cfg)
    _, jbuf, jh = j_grids.static_cell(jr, jp, jcfg)
    assert share(buf, jbuf) >= 0.999 and share(h, jh) >= 0.999

    lc_lvl = t_lc._lc_level(T(pos), T(cam), cfg)
    j_lvl = j_lc._lc_level(jp, jc, jcfg)
    assert share(lc_lvl, j_lvl) >= 0.999
    _, buf, h = t_lc._lc_cell(tr, T(pos), T(nrm), T(np.array(j_lvl)), cfg)
    _, jbuf, jh = j_lc._lc_cell(jr, jp, jn, j_lvl, jcfg)
    assert share(buf, jbuf) >= 0.999 and share(h, jh) >= 0.999
    assert buf.max() < cfg.lc_size


def _unxorshift32(y):
    """The state whose next xorshift32 value is ``y``."""
    def undo(x, shift, left):
        r = x
        for _ in range(32 // shift + 1):
            r = x ^ ((r << shift) & 0xFFFFFFFF if left else r >> shift)
        return r
    return undo(undo(undo(y, 5, True), 17, False), 13, True)


def test_new_state_id_wrap_and_saturation():
    """ids are u32: (u · 4294967295).astype(u32) saturates where the f32
    uniform rounds to 1.0, ids ≥ 2^31 ride the i32 queue column as
    negative values and come back."""
    nxt = [0xFFFFFFFF, 0xFFFFFF80, 0xFFFFFF7F, 0x80000000, 0x7FFFFFFF, 0x80000080, 1]
    st = np.asarray([_unxorshift32(y) for y in nxt], np.uint32)
    assert [int(v) for v in _u64(j_rng.xorshift32_raw(jnp.asarray(st)))] == nxt
    jr, jn = j_grids.new_state(jnp.asarray(st))
    tr, tn = grids.new_state(T(st.astype(np.int64)))
    np.testing.assert_array_equal(tn.id.numpy(), _u64(jn.id))
    assert tn.id[0] == 0xFFFFFFFF and tn.id[1] == 0xFFFFFFFF and tn.id[3] == 1 << 31
    np.testing.assert_array_equal(tr.numpy(), _u64(jr))
    z3, z = np.zeros((len(nxt), 3), np.float32), np.zeros(len(nxt), np.float32)
    cell = np.arange(len(nxt), dtype=np.int32)
    jq = j_surf.UpdateQueue.build(
        cell=jnp.asarray(cell), id=jn.id, w=jnp.asarray(z), target=jnp.asarray(z3),
        mv=jnp.asarray(z3), pos=jnp.asarray(z3), normal=jnp.asarray(z3),
        mask=jnp.ones(len(nxt), bool), sentinel=99,
    )
    tq = UpdateQueue.build(
        cell=T(cell), id=tn.id, w=T(z), target=T(z3), mv=T(z3), pos=T(z3), normal=T(z3),
        mask=torch.ones(len(nxt), dtype=torch.bool), sentinel=99,
    )
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    assert (tq.data[:, 13] < 0).sum() >= 3
    np.testing.assert_array_equal(tq.id.numpy(), tn.id.numpy())


def _sample(mod, conv, ids, w_tgt, sum_w, w_cos, mv, t, n, hashes):
    return mod.StateSample(
        id=conv(np.asarray(ids, np.uint32)), w_tgt=conv(np.asarray(w_tgt, np.float32)),
        sum_w=conv(np.asarray(sum_w, np.float32)), w_cos=conv(np.asarray(w_cos, np.float32)),
        mv=conv(np.asarray(mv, np.float32)), T=conv(np.asarray(t, np.float32)),
        N=conv(np.asarray(n, np.int32)), hash=conv(np.asarray(hashes, np.uint32)),
    )


_T_U32 = lambda a: T(a.astype(np.int64)) if a.dtype == np.uint32 else T(a)


def test_finalize_load_collision_reset_and_reprojection():
    args = ([1, 2], [[10.0, 0, 0]] * 2, [2.0, 2.0], [1.0, 1.0], [[1.0, 0, 0]] * 2,
            [0.0, 0.0], [5, 5], [42, 42])
    out = grids.finalize_load(_sample(grids, _T_U32, *args), torch.tensor([42, 43]), cl_time=2.0)
    jout = j_grids.finalize_load(
        _sample(j_grids, jnp.asarray, *args), jnp.asarray([42, 43], jnp.uint32), cl_time=2.0)
    # matching hash: target moved by sum_w * dt * mv = 2*2*1 = 4
    np.testing.assert_allclose(out.w_tgt[0].numpy(), [14.0, 0, 0])
    assert float(out.sum_w[0]) == 2.0
    # hash mismatch: reset sum_w → no reprojection either
    assert float(out.sum_w[1]) == 0.0
    np.testing.assert_allclose(out.w_tgt[1].numpy(), [10.0, 0, 0])
    np.testing.assert_array_equal(out.w_tgt.numpy(), np.asarray(jout.w_tgt))
    np.testing.assert_array_equal(out.sum_w.numpy(), np.asarray(jout.sum_w))


def _table(S=8):
    rng = np.random.default_rng(7)
    f = np.zeros((S, 9), np.float32)
    f[:, 0:3] = rng.normal(size=(S, 3)) * 50.0  # w_tgt
    f[:, 3] = np.abs(rng.normal(size=S)) + 0.1  # sum_w
    f[:, 4] = rng.random(S).astype(np.float32)  # w_cos
    f[:, 5:8] = rng.normal(size=(S, 3))  # mv
    f[:, 8] = rng.random(S) * 3.0  # T
    f[3, 3] = -1.0  # tombstone: must NOT be reprojected
    i = np.zeros((S, 3), np.int32)
    i[:, 0] = rng.integers(-2**31, 2**31 - 1, S)  # ids ≥ 2^31 are negative here
    i[0, 0] = -5
    i[:, 1] = rng.integers(1, 1000, S)
    i[:, 2] = rng.integers(0, 2**16, S)
    return f, i


def test_packed_draw_table_roundtrip():
    """gather_state_packed_draw(pack_states_draw(mc, t)) + finalize
    agrees with gather_state(mc) + finalize on every field the guided
    sampler reads, including hash-mismatch and tombstone rows; the table
    equals the JAX package's bit for bit."""
    S = 8
    f, i = _table(S)
    mc = MCStates(f=T(f), i=T(i))
    t = torch.tensor(5.5)
    idx = torch.arange(S)
    hashes = T(i[:, 2].astype(np.int64))
    bad_hashes = hashes.clone()
    bad_hashes[5] ^= 0x1  # row 5: mismatch

    packed = grids.pack_states_draw(mc, t)
    j_packed = j_grids.pack_states_draw(JMCStates(f=jnp.asarray(f), i=jnp.asarray(i)), jnp.float32(5.5))
    assert packed.dtype == torch.int32
    close = np.isclose(
        packed[:, :3].contiguous().view(torch.float32).numpy(),
        np.asarray(j_packed[:, :3]).view(np.float32), rtol=1e-6,
    )
    assert close.all()  # a multiply-add: XLA may fuse it
    np.testing.assert_array_equal(packed[:, 3:].numpy(), np.asarray(j_packed[:, 3:]))

    a = grids.finalize_load(grids.gather_state_packed_draw(packed, idx), bad_hashes, t)
    b = grids.finalize_load(grids.gather_state(mc, idx), bad_hashes, t)
    assert torch.equal(a.id, b.id) and (a.id >= 0).all() and a.id[0] == 2**32 - 5
    np.testing.assert_array_equal(a.id.numpy(), _u64(JMCStates(f=jnp.asarray(f), i=jnp.asarray(i)).id))
    assert torch.equal(a.N, b.N) and torch.equal(a.hash, b.hash)
    np.testing.assert_allclose(a.sum_w.numpy(), b.sum_w.numpy(), rtol=1e-6)
    np.testing.assert_allclose(a.w_cos.numpy(), b.w_cos.numpy(), rtol=1e-6)
    valid = np.ones(S, bool)
    valid[5] = False
    np.testing.assert_allclose(a.w_tgt.numpy()[valid], b.w_tgt.numpy()[valid], rtol=1e-5)
    assert float(a.sum_w[5]) == 0.0
    assert float(a.sum_w[3]) == 0.0  # tombstone reset
    np.testing.assert_allclose(a.w_tgt.numpy()[3], f[3, 0:3], rtol=1e-6)

    pf, pi = grids.pack_sample(grids.gather_state(mc, idx))
    assert torch.equal(pf, mc.f) and torch.equal(pi, mc.i)


def test_vmf_kappa_grows_with_mean_cos():
    def both(w_cos, n=100):
        args = ([1], [[100.0, 0, 0]], [1.0], [w_cos], np.zeros((1, 3)), [0.0], [n], [0])
        pos = np.zeros((1, 3), np.float32)
        mu, k = grids.state_vmf(_sample(grids, _T_U32, *args), T(pos), CFG)
        jmu, jk = j_grids.state_vmf(_sample(j_grids, jnp.asarray, *args), jnp.asarray(pos), JCFG)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-5)
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=1e-6)
        return mu, k

    _, k_low = both(0.3)
    _, k_high = both(0.95)
    assert float(k_high[0]) > float(k_low[0]) > 0.0
    mu, _ = both(0.9)
    np.testing.assert_allclose(mu[0].numpy(), [1.0, 0, 0], atol=1e-6)
    _, k_cap = both(1.0, n=1000)
    assert float(k_cap[0]) == CFG.kappa_max


def test_state_lobes_and_light_missing_on_random_states():
    n = 4096
    r = np.random.default_rng(11)
    args = (
        r.integers(0, 2**32, n), r.normal(size=(n, 3)) * 80.0, np.abs(r.normal(size=n)) * (r.random(n) > 0.2),
        r.random(n), r.normal(size=(n, 3)), r.random(n), r.integers(0, 1025, n), r.integers(0, 2**16, n),
    )
    pos, _, _ = _cloud(n, seed=12)
    wo = _cloud(n, seed=13)[1]
    mc_f = (r.random(n) * 2.0).astype(np.float32)
    ts, js = _sample(grids, _T_U32, *args), _sample(j_grids, jnp.asarray, *args)
    mu, k = grids.state_vmf(ts, T(pos), CFG)
    jmu, jk = j_grids.state_vmf(js, jnp.asarray(pos), JCFG)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=2e-6)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=2e-5, atol=1e-6)
    miss = grids.light_missing(ts, T(mc_f), T(wo), T(pos), CFG)
    j_miss = np.asarray(j_grids.light_missing(js, jnp.asarray(mc_f), jnp.asarray(wo), jnp.asarray(pos), JCFG))
    assert (miss.numpy() == j_miss).mean() >= 0.999  # a >= on a float (read: 1.0)


def test_light_cache_learns_and_reads_back():
    st, jst = init_mcpg_state(CFG, device="cpu"), j_init_mcpg_state(JCFG)
    cam = np.zeros(3, np.float32)
    m = 256
    pos = np.full((m, 3), [50.0, 10.0, 5.0], np.float32)
    nrm = np.full((m, 3), [0.0, 0.0, 1.0], np.float32)
    irr = np.full((m, 3), [2.0, 1.0, 0.5], np.float32)
    lc, jlc = st.lc, jst.lc
    jr, r = _rngs(m)
    for _ in range(60):
        r, lc, applied, merged = t_lc.lc_update_batch(
            r, lc, T(pos), T(nrm), T(irr), torch.ones(m, dtype=torch.bool), T(cam), CFG)
        jr, jlc, j_applied, j_merged = j_lc.lc_update_batch(
            jr, jlc, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(irr), jnp.ones((m,), bool),
            jnp.asarray(cam), JCFG)
    assert int(applied) == int(j_applied) > 0 and int(merged) == int(j_merged)
    assert applied.dtype == torch.int64 and applied.dim() == 0
    np.testing.assert_array_equal(lc.hash.numpy(), _u64(jlc.hash))
    np.testing.assert_array_equal(lc.N.numpy(), np.asarray(jlc.N))
    np.testing.assert_allclose(lc.irr.numpy(), np.asarray(jlc.irr), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(r.numpy(), _u64(jr))
    jr2, tr2 = _rngs(m, seed=9)
    _, got = t_lc.lc_get(tr2, lc, T(pos), T(nrm), T(cam), CFG)
    _, j_got = j_lc.lc_get(jr2, jlc, jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(cam), JCFG)
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(j_got), rtol=1e-5, atol=1e-6)
    hit = got.sum(-1) > 0
    assert hit.mean() > 0.9  # stochastic cell jitter may miss rarely
    np.testing.assert_allclose(got[hit].mean(0), [2.0, 1.0, 0.5], rtol=0.25)
    # a non-finite sample is masked out before the sums
    bad = irr.copy()
    bad[3] = np.nan
    bad[7, 1] = np.inf
    _, lc2, applied2, merged2 = t_lc.lc_update_batch(
        r, lc, T(pos), T(nrm), T(bad), torch.ones(m, dtype=torch.bool), T(cam), CFG)
    assert torch.isfinite(lc2.irr).all() and int(applied2 + merged2) == m - 2


def test_f16_pair_lanes_bit_exact():
    from merian_quake_tpu.render.mcpg.updates import _pack_f16_pair as j_pack
    from merian_quake_tpu.render.mcpg.updates import _unpack_f16_pair as j_unpack

    r = np.random.default_rng(5)
    a = np.concatenate([r.random(4096) * 10.0, [0.0, -1.0, 6e4, 7e4, 65504.0, 1e-8, 6.1e-5, 2049.0, 2051.0]]).astype(np.float32)
    b = np.concatenate([r.random(4096) * 7e4, [5.0, 1.0, 0.0, 3.0, 2.0, 1.0, 0.5, 0.1, 33000.0]]).astype(np.float32)
    p, jp = t_lc.pack_f16_pair(T(a), T(b)), j_pack(jnp.asarray(a), jnp.asarray(b))
    assert p.dtype == torch.int32
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    lo, hi = t_lc.unpack_f16_pair(p)
    jlo, jhi = j_unpack(jp)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    # any lane pattern unpacks alike, sign bits of both halves included
    raw = r.integers(-2**31, 2**31, 4096).astype(np.int32)
    lo, hi = t_lc.unpack_f16_pair(T(raw))
    jlo, jhi = j_unpack(jnp.asarray(raw))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert (lo < 0).any() and (hi < 0).any()


# ---- the replay on queues built by hand ----


def _result(mod, conv, m, cells, ids, w, tgt, pos, nrm, live, sentinel, zero_cell=None, zero_mask=None,
            lc_irr=None, lc_mask=None):
    z3 = np.zeros((m, 3), np.float32)
    f32 = lambda x: conv(np.asarray(x, np.float32))
    upq = mod.UpdateQueue.build(
        cell=conv(np.asarray(cells, np.int32)),
        id=conv(np.asarray(ids, np.uint32)) if mod is j_surf else T(np.asarray(ids, np.int64)),
        w=f32(w), target=f32(tgt), mv=f32(z3), pos=f32(pos), normal=f32(nrm),
        mask=conv(np.asarray(live, bool)), sentinel=sentinel,
    )
    return mod.SurfaceResult(
        irradiance=f32(np.zeros((1, 1, 4))), updates=upq,
        lc_samples=mod.LCQueue(
            pos=f32(pos), normal=f32(nrm), irr=f32(z3 if lc_irr is None else lc_irr),
            mask=conv(np.zeros(m, bool) if lc_mask is None else np.asarray(lc_mask, bool)),
        ),
        zeros=mod.ZeroQueue(
            cell=conv(np.zeros(m, np.int32) if zero_cell is None else np.asarray(zero_cell, np.int32)),
            mask=conv(np.zeros(m, bool) if zero_mask is None else np.asarray(zero_mask, bool)),
        ),
    )


def _replay_both(key, st, jst, cfg, jcfg, cl_time, **q):
    uni = j_default_uniforms(cl_time=cl_time)
    st2 = apply_updates(key, st, _result(t_surf, T, sentinel=cfg.mc_total_size, **q),
                        interop.uniforms_from_numpy(uni, "cpu"), cfg)
    jst2 = j_apply_updates(jnp.uint32(key), jst, _result(j_surf, jnp.asarray, sentinel=cfg.mc_total_size, **q),
                           uni, jcfg)
    np.testing.assert_array_equal(st2.mc.i.numpy(), np.asarray(jst2.mc.i))
    np.testing.assert_allclose(st2.mc.f.numpy(), np.asarray(jst2.mc.f), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(st2.lc.hash.numpy(), _u64(jst2.lc.hash))
    np.testing.assert_array_equal(st2.lc.N.numpy(), np.asarray(jst2.lc.N))
    np.testing.assert_allclose(st2.lc.irr.numpy(), np.asarray(jst2.lc.irr), rtol=1e-5, atol=1e-6)
    assert int(st2.lc_updates_applied) == int(jst2.lc_updates_applied)
    assert int(st2.lc_updates_merged) == int(jst2.lc_updates_merged)
    return st2, jst2


def test_apply_updates_creates_and_matures_chains():
    st, jst = init_mcpg_state(CFG, device="cpu"), j_init_mcpg_state(JCFG)
    m = 64
    pos = np.full((m, 3), [50.0, 10.0, 5.0], np.float32)
    nrm = np.full((m, 3), [0.0, 0.0, 1.0], np.float32)
    tgt = np.full((m, 3), [50.0, 10.0, 105.0], np.float32)
    # round 1: fresh chains at arbitrary cells, with light-cache samples
    st1, jst1 = _replay_both(
        5, st, jst, CFG, JCFG, 1.0, m=m, cells=np.arange(m), ids=np.full(m, 0xF0000077),
        w=np.full(m, 3.0), tgt=tgt, pos=pos, nrm=nrm, live=np.ones(m, bool),
        lc_irr=np.full((m, 3), [2.0, 1.0, 0.5]), lc_mask=np.arange(m) % 3 > 0,
    )
    sw = st1.mc.sum_w.numpy()
    assert (sw > 0).sum() >= 1  # winner saved into both grids
    act = np.where(sw > 0)[0]
    sp = st1.mc.w_tgt.numpy()[act] / sw[act][:, None]
    np.testing.assert_allclose(sp, np.broadcast_to(tgt[0], sp.shape), atol=1.0)
    assert (st1.mc.i[:, 0] < 0).any() and (st1.mc.id[act] == 0xF0000077).all()
    assert int(st1.lc_updates_applied) > 0

    # round 2: matching ids at the occupied cells → N grows
    occ = act[:8]
    m2 = len(occ)
    st2, _ = _replay_both(
        6, st1, jst1, CFG, JCFG, 1.0, m=m2, cells=occ, ids=st1.mc.id.numpy()[occ],
        w=np.full(m2, 3.0), tgt=tgt[:m2], pos=pos[:m2], nrm=nrm[:m2], live=np.ones(m2, bool),
    )
    assert int(st2.mc.N.max()) >= 2


def test_fast_recovery_zeroes_state():
    st, jst = init_mcpg_state(CFG, device="cpu"), j_init_mcpg_state(JCFG)
    st.mc.f[10, 3] = 5.0
    jst = jst._replace(mc=jst.mc._replace(f=jst.mc.f.at[10, 3].set(5.0)))
    m = 4
    z3 = np.zeros((m, 3), np.float32)
    st2, _ = _replay_both(
        1, st, jst, CFG, JCFG, 0.0, m=m, cells=np.zeros(m), ids=np.zeros(m), w=np.zeros(m),
        tgt=z3, pos=z3, nrm=z3, live=np.zeros(m, bool),
        zero_cell=[10, 0, 0, 0], zero_mask=[True, False, False, False],
    )
    assert float(st2.mc.sum_w[10]) == 0.0
    assert float(st.mc.sum_w[10]) == 5.0  # out of place


def test_apply_updates_mixed_queue_and_overflow_drop():
    """Compaction keeps the EARLIEST live rows when the queue overflows
    capacity, zero requests ride the suffix, dead rows are ignored."""
    kw = dict(update_queue_capacity=8, zero_queue_capacity=4)
    cfg, jcfg = CFG._replace(**kw), JCFG._replace(**kw)
    st, jst = init_mcpg_state(cfg, device="cpu"), j_init_mcpg_state(jcfg)
    st.mc.f[33, 3] = 9.0
    jst = jst._replace(mc=jst.mc._replace(f=jst.mc.f.at[33, 3].set(9.0)))
    m = 32
    pos = np.full((m, 3), [50.0, 10.0, 5.0], np.float32)
    nrm = np.full((m, 3), [0.0, 0.0, 1.0], np.float32)
    tgt = np.full((m, 3), [50.0, 10.0, 105.0], np.float32)
    # 12 live rows (> capacity 8), interleaved with dead rows; one zero
    live = (np.arange(m) % 2 == 0) & (np.arange(m) < 24)
    q = dict(m=m, cells=np.arange(m), ids=np.full(m, 7), w=np.full(m, 2.0), tgt=tgt, pos=pos,
             nrm=nrm, live=live, zero_cell=np.full(m, 33), zero_mask=np.arange(m) == 25)
    st2, _ = _replay_both(3, st, jst, cfg, jcfg, 1.0, **q)
    assert float(st2.mc.sum_w[33]) == 0.0  # the zero request landed despite overflow
    assert (st2.mc.sum_w > 0).sum() >= 1
    # with capacities far above 1024 and 256 rows: min(M, max(cap, 1024)) rows stay
    from merian_quake_tpu_torch.render.mcpg.updates import compact_queues

    res = _result(t_surf, T, sentinel=cfg.mc_total_size, **q)
    g = torch.arange(m, dtype=torch.int32)
    cq = compact_queues(res, cfg, g, g)
    assert cq.upd.shape == (m, 16) and cq.zeros.shape == (m,) and cq.lc.shape == (m, 7)
    assert (cq.upd[:12, 15] == torch.arange(0, 24, 2)).all()  # live prefix in row order
    assert (cq.zeros < cfg.mc_total_size).sum() == 1 and cq.zeros[-1] == 33
