"""The volume pass (render/mcpg/volume.py) and the reprojected
accumulation: port against JAX package, same numpy inputs.

Twins of tests/test_volume.py on the port alone (fog scaling, finite
output and learned depth, the regulariser, reprojected accumulation
under camera motion).

One step of ``render_volume`` on the fogged court (``fog_mu_t`` 0.002),
64×36, 1 spp, max path length 3, ``MCPGConfig()`` grids with the
production volume (2 volume spp, distance guiding 0.9, light cache
lookups, 7 µm particles): three jitted JAX frames warm the guiding and
distance states, then frame 3's gbuffer, guiding state and volume state
go to both packages. Read against the jitted pass: every distance-queue
slot (605 live rows) and N, every update cell and id (2,036 live rows),
the zero and light-cache masks EQUAL; the queued floats within rtol 1e-3
on 99.67-99.83% of rows; the image within 1e-3 on 99.740% of pixels,
mean |Δ| 9.14e-6; the motion vectors 100%, max 2.3e-5. The JAX package's
jitted pass reads the same against its own op-by-op run
(``jax.disable_jit``): image 99.740%, 9.14e-6, so the port's floats are
held to that spread (image ≥ 99.5%, < 1.15e-5; floats ≥ 99%); against
the op-by-op run the port reads 100% and 1.8e-8. Two mutants fail: the
distance guiding ignored, the phase pdf dropped.

``compact_dist``, ``apply_dist_updates`` and ``_forward_project`` are
held bit for bit on forced duplicate slots and targets, and the
compaction's overflow branch against a numpy model of "the first
``cap`` live rows in row order".
"""
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu import renderer as j_renderer
from merian_quake_tpu.accel.build import build_accel as j_build_accel
from merian_quake_tpu.accel.build import scene_features as j_scene_features
from merian_quake_tpu.models.procedural import outdoor_court as j_court
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.models.types import default_uniforms as j_default_uniforms
from merian_quake_tpu.render.gbuffer import render_gbuffer as j_render_gbuffer
from merian_quake_tpu.render.mcpg import MCPGConfig as JMCPGConfig
from merian_quake_tpu.render.mcpg import volume as j_vol
from merian_quake_tpu.render.mcpg.config import production_config as j_production_config
from merian_quake_tpu.render.mcpg.surface import DistQueue as JDistQueue
from merian_quake_tpu_torch import interop
from merian_quake_tpu_torch.accel.build import build_accel, scene_features
from merian_quake_tpu_torch.models.procedural import cornell_box, get_scene, outdoor_court
from merian_quake_tpu_torch.models.types import RenderConfig, default_uniforms
from merian_quake_tpu_torch.ops import phase
from merian_quake_tpu_torch.render.mcpg import MCPGConfig
from merian_quake_tpu_torch.render.mcpg import volume as t_vol
from merian_quake_tpu_torch.render.mcpg.config import production_config
from merian_quake_tpu_torch.render.mcpg.surface import DistQueue
from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig, _normal_dist
from merian_quake_tpu_torch.renderer import init_state, render_frame, render_sequence

torch.set_num_threads(min(2, torch.get_num_threads()))

# the modules (each package's post/__init__ binds the name to a function)
j_acc = sys.modules["merian_quake_tpu.post.accumulate"]
t_acc = sys.modules["merian_quake_tpu_torch.post.accumulate"]
T = torch.from_numpy


# ---- twins of tests/test_volume.py ----


def _run(mu_t, frames=3, seed=1337, spp=1):
    cfg = RenderConfig(width=40, height=24, spp=1, integrator="mcpg", seed=seed)
    mcfg = MCPGConfig(volume=VolumeConfig(volume_spp=spp))
    bundle = get_scene("box", device="cpu")
    u = bundle.uniforms._replace(
        mu_t=torch.tensor(mu_t, dtype=torch.float32), mu_s=torch.full((3,), mu_t * 0.8)
    )
    return render_sequence(bundle._replace(uniforms=u), cfg, frames=frames, mcpg_config=mcfg,
                           device="cpu")


def test_volume_scales_with_fog_density():
    v = [float(_run(mu)[0].accum_volume[..., :3].mean()) for mu in (0.0, 0.0004, 0.0008)]
    assert v[0] == 0.0
    assert v[2] > v[1] > 0.0
    # optically thin (mu_t·z ≈ 0.1..0.25): in-scatter ≈ linear in mu_s
    assert 1.4 < v[2] / v[1] < 2.9, v


def test_volume_finite_and_depth_learned():
    st, out = _run(0.004, frames=6)
    assert torch.isfinite(st.accum_volume).all()
    depth = st.volume.volume_depth
    # expected scatter depth lies within (0, surface depth]
    assert (depth > 0).all() and (depth <= out["gbuffer"].linear_z + 1.0).all()
    # distance chains learn where scattering found light
    assert int((st.volume.dist_mc.sum_w > 0).sum()) > 0
    assert out["volume"].shape == (24, 40, 4) and out["volume_mv"].shape == (24, 40, 2)


def test_normal_dist_regularizer():
    sw = torch.tensor([2.0])
    mm = torch.tensor([[2.0 * 100.0, 2.0 * (100.0**2 + 25.0)]])  # mu=100 var=25
    mu, sigma = _normal_dist(sw, torch.tensor([1000]), mm)
    np.testing.assert_allclose(float(mu[0]), 100.0, rtol=1e-5)
    np.testing.assert_allclose(float(sigma[0]), 5.0, rtol=0.01)
    # tiny N → prior dominates → sigma pulled toward 0.2/0.2 scale
    _, sigma2 = _normal_dist(sw, torch.tensor([0]), mm)
    assert float(sigma2[0]) < 2.0


def test_volume_reprojected_accumulate_beats_plain_under_motion():
    """With a translating camera, reprojected accumulation of the
    per-frame volume images tracks the fog field better than a plain
    (ghosting) blend."""
    bundle = cornell_box(device="cpu")
    cfg = RenderConfig(width=48, height=32, spp=1, integrator="mcpg", seed=7, max_path_length=2)
    mcfg = MCPGConfig(mc_adaptive_size=1 << 10, mc_static_size=1 << 8, lc_size=1 << 10,
                      volume=VolumeConfig(volume_spp=2))
    accel = build_accel(bundle.scene, bundle.atlas, device="cpu")
    u0 = bundle.uniforms._replace(
        mu_t=torch.tensor(0.004, dtype=torch.float32), mu_s=torch.full((3,), 0.0032))
    cfg = cfg._replace(features=scene_features(bundle.scene, u0, bundle.atlas))
    cam_at = lambda i: u0.cam_x + torch.tensor([0.0, 12.0 * i, 0.0])  # slides +y

    frames = 5
    state = init_state(cfg, mcfg, device="cpu")
    vols, mvs = [], []
    for i in range(frames):
        u = u0._replace(cam_x=cam_at(i), prev_cam_x=cam_at(i - 1), frame=i)
        state, out = render_frame(accel, bundle.atlas, u, cfg, state, mcfg)
        vols.append(out["volume"])
        mvs.append(out["volume_mv"])
    # unbiased estimate of the FINAL camera's volume field
    truth = torch.zeros_like(vols[0][..., :3])
    n_ref = 6
    for j in range(n_ref):
        st = init_state(cfg, mcfg, device="cpu")
        u = u0._replace(cam_x=cam_at(frames - 1), prev_cam_x=cam_at(frames - 1), frame=1000 + 37 * j)
        _, out = render_frame(accel, bundle.atlas, u, cfg, st, mcfg)
        truth += out["volume"][..., :3] / n_ref
    plain = torch.stack([v[..., :3] for v in vols]).mean(0)
    acc, n = torch.zeros_like(vols[0]), torch.zeros(vols[0].shape[:2])
    for v, mv in zip(vols, mvs):
        acc, n = t_acc.accumulate_reprojected(acc, n, v, mv)
    err_plain = float((plain - truth).abs().mean())
    err_repro = float((acc[..., :3] - truth).abs().mean())
    assert err_repro < err_plain, (err_repro, err_plain)


# ---- one step of render_volume on state carried from a warmed JAX run ----

W, H, MU = 64, 36, 0.002


class Warm:
    def __init__(self):
        self.jcfg_m = jm = JMCPGConfig(volume=j_production_config().volume)
        b = j_court(MU)
        acc = j_build_accel(b.scene, b.atlas)
        jcfg = JConfig(width=W, height=H, spp=1, max_path_length=3, integrator="mcpg",
                       features=j_scene_features(b.scene, b.uniforms, b.atlas))
        st = j_renderer.init_state(jcfg, jm)
        step = jax.jit(lambda u, s: j_renderer.frame_core(acc, b.atlas, u, jcfg, s, mcpg_config=jm)[0])
        for i in range(3):
            st = step(b.uniforms._replace(frame=jnp.uint32(i)), st)
        self.j_state = st
        uni = b.uniforms._replace(frame=jnp.uint32(3))
        gbuf = jax.jit(lambda u: j_render_gbuffer(acc, b.atlas, u, jcfg))(uni)
        self.j_out = jax.jit(lambda u, m, v, g: j_vol.render_volume(
            acc, b.atlas, u, jcfg, jm, jm.volume, m, v, g))(uni, st.mcpg, st.volume, gbuf)

        self.mcfg = MCPGConfig(volume=production_config().volume)
        self.bundle = tb = outdoor_court(MU, device="cpu")
        self.accel = build_accel(tb.scene, tb.atlas, device="cpu")
        self.cfg = RenderConfig(width=W, height=H, spp=1, max_path_length=3, integrator="mcpg",
                                features=scene_features(tb.scene, tb.uniforms, tb.atlas))
        self.uni = interop.uniforms_from_numpy(uni, "cpu")
        self.mstate = interop.mcpg_state_from_numpy(st.mcpg, "cpu")
        self.vstate = interop.volume_state_from_numpy(st.volume, "cpu")
        self.gbuf = interop.gbuffer_from_numpy(gbuf, "cpu")

    def port(self, vcfg=None):
        return t_vol.render_volume(
            self.accel, self.bundle.atlas, self.uni, self.cfg, self.mcfg, vcfg or self.mcfg.volume,
            self.mstate, self.vstate, self.gbuf)


@pytest.fixture(scope="module")
def warm():
    return Warm()


def _agree(ours, ref, share, mean):
    d = np.abs(ours.numpy() - np.asarray(ref))
    per_pixel = d.max(-1) if d.ndim == 3 else d
    assert (per_pixel <= 1e-3).mean() >= share, (per_pixel <= 1e-3).mean()
    assert d.mean() < mean, d.mean()


def _step_agrees(port_out, j_out, mcfg):
    img, mv, vstate, extra = port_out
    j_img, j_mv, j_vstate, j_extra = j_out
    S = mcfg.mc_total_size
    jd, td = np.asarray(j_extra.dist.data), extra.dist.data.numpy()
    ju, tu = np.asarray(j_extra.updates.data), extra.updates.data.numpy()
    assert td.shape == jd.shape == (2 * W * H, 5) and tu.shape == ju.shape == (2 * W * H, 15)
    assert (td[:, 4] == jd[:, 4]).mean() >= 0.995  # tiles and slots, with the mask
    assert (td[:, 3] == jd[:, 3]).mean() >= 0.995  # chain lengths
    assert (tu[:, 14] == ju[:, 14]).mean() >= 0.995  # cells, with the mask
    assert (tu[:, 13] == ju[:, 13]).mean() >= 0.995  # ids
    for q in ("zeros", "lc_samples"):
        assert (getattr(extra, q).mask.numpy() == np.asarray(getattr(j_extra, q).mask)).mean() >= 0.995
    live_d = (jd[:, 4] < jd[:, 4].max()) & (td[:, 4] < td[:, 4].max())
    live_u = (ju[:, 14] < S) & (tu[:, 14] < S)
    for a, b, rows in ((td[:, 0:3], jd[:, 0:3], live_d), (tu[:, 0:13], ju[:, 0:13], live_u)):
        a, b = a[rows].view(np.float32), b[rows].view(np.float32)
        assert np.isclose(a, b, rtol=1e-3, atol=1e-5).all(-1).mean() >= 0.99
    _agree(img, j_img, 0.995, 1.15e-5)
    _agree(mv, j_mv, 1.0, 1e-5)
    _agree(vstate.volume_depth, j_vstate.volume_depth, 0.995, 1e-3)


def test_render_volume_step_on_carried_state(warm):
    out = warm.port()
    _step_agrees(out, warm.j_out, warm.mcfg)
    img, _, vstate, extra = out
    S = warm.mcfg.mc_total_size
    assert (extra.dist.data[:, 4] < vstate.dist_mc.sum_w.numel()).sum() > 300  # queued writes
    assert (extra.updates.cell < S).sum() > 1000 and (extra.updates.id > 2**31).any()
    assert not extra.lc_samples.mask.any()
    assert torch.isfinite(img).all() and float(img[..., :3].mean()) > 0.01
    assert torch.equal(vstate.dist_mc.sum_w, warm.vstate.dist_mc.sum_w)  # writes are deferred


@pytest.mark.parametrize("mutant", ["dist_guide_p", "phase_pdf"])
def test_render_volume_mutant_fails(warm, monkeypatch, mutant):
    vcfg = None
    if mutant == "dist_guide_p":  # the distance guiding ignored
        vcfg = warm.mcfg.volume._replace(dist_guide_p=0.0)
    else:  # the phase pdf dropped from the MIS pdf and the estimate
        shim = types.SimpleNamespace(**{**vars(phase), "draine_pdf": lambda c, g, a: torch.ones_like(c)})
        monkeypatch.setattr(t_vol, "phase_ops", shim)
    with pytest.raises(AssertionError):
        _step_agrees(warm.port(vcfg), warm.j_out, warm.mcfg)


# ---- the distance-MC queue: compaction and replay ----


def _dist_rows(m, total, seed, live_share=0.5, n_flat=None):
    """A hand-made DistQueue of ``m`` rows on ``total`` states, many rows
    on a few slots (``n_flat``), with random gidx."""
    r = np.random.default_rng(seed)
    f = lambda: r.uniform(0.0, 50.0, m).astype(np.float32)
    flat = r.integers(0, n_flat or total, m).astype(np.int32)
    mask = r.random(m) < live_share
    cols = dict(sw=f(), m0=f(), m1=f(), n_chain=r.integers(1, 1024, m).astype(np.int32),
                flat=flat, mask=mask, sentinel=total)
    gidx = r.permutation(m * 3)[:m].astype(np.int32)
    return cols, gidx


def _both_queues(cols):
    tq = DistQueue.build(**{k: T(v) if isinstance(v, np.ndarray) else v for k, v in cols.items()})
    jq = JDistQueue.build(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                             for k, v in cols.items()})
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    return tq, jq


def _grids(c=12, k=10, seed=4):
    r = np.random.default_rng(seed)
    sw, n, mm = (r.uniform(0, 5, (c, k)).astype(np.float32), r.integers(0, 9, (c, k)).astype(np.int32),
                 r.uniform(0, 9, (c, k, 2)).astype(np.float32))
    return t_vol.DistanceMC(T(sw), T(n), T(mm)), j_vol.DistanceMC(jnp.asarray(sw), jnp.asarray(n),
                                                                   jnp.asarray(mm))


@pytest.mark.parametrize("seed, n_flat", [(1, None), (2, 7), (3, 1)])
def test_compact_and_apply_dist_bit_exact_on_duplicate_slots(seed, n_flat):
    """Up to 2,000 rows on 120 states (or on 7, or all on one): many
    rows per slot; the max-gidx row writes each slot, in both packages."""
    tdmc, jdmc = _grids()
    total = tdmc.sum_w.numel()
    cols, gidx = _dist_rows(2000, total, seed, n_flat=n_flat)
    tq, jq = _both_queues(cols)
    tc = t_vol.compact_dist(tq, total, T(gidx))
    jc = np.asarray(j_vol.compact_dist(jq, total, jnp.asarray(gidx)))
    live = jc[:, 4] < total
    assert tc.shape == jc.shape == (2000, 6) and live.sum() > 500
    np.testing.assert_array_equal(tc.numpy()[live], jc[live])  # the live prefix, in row order
    assert (tc.numpy()[~live, 4] == total).all() and live[: live.sum()].all()
    got = t_vol.apply_dist_updates(tdmc, tc)
    want = j_vol.apply_dist_updates(jdmc, jnp.asarray(jc))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the winner does not depend on the rows' order
    again = t_vol.apply_dist_updates(tdmc, tc.flip(0))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    written = (got.N != tdmc.N).sum()
    assert written > 0 if n_flat != 1 else written <= 1


def test_compact_dist_overflow_keeps_first_live_rows(monkeypatch):
    """Past the capacity the first ``cap`` live rows in row order survive
    (a numpy model), and the replay takes the max-gidx row among them."""
    monkeypatch.setattr(t_vol, "DIST_QUEUE_CAPACITY", 256)
    tdmc, _ = _grids()
    total = tdmc.sum_w.numel()
    cols, gidx = _dist_rows(4096, total, 9)
    tq = DistQueue.build(**{k: T(v) if isinstance(v, np.ndarray) else v for k, v in cols.items()})
    got = t_vol.compact_dist(tq, total, T(gidx)).numpy()
    data = np.concatenate([tq.data.numpy(), gidx[:, None]], 1)
    first = np.nonzero(data[:, 4] < total)[0]
    assert len(first) > 1000  # overflow
    np.testing.assert_array_equal(got, data[first[:256]])
    new = t_vol.apply_dist_updates(tdmc, T(got))
    sw, n, mm = (x.reshape(total, -1).numpy().copy() for x in tdmc)
    for row in sorted(got, key=lambda r: r[5]):  # ascending gidx: the last writes
        sw[row[4]], n[row[4]] = row[0:1].view(np.float32), row[3]
        mm[row[4]] = row[1:3].view(np.float32)
    np.testing.assert_array_equal(new.sum_w.reshape(total, -1).numpy(), sw)
    np.testing.assert_array_equal(new.N.reshape(total, -1).numpy(), n)
    np.testing.assert_array_equal(new.moments.reshape(total, -1).numpy(), mm)


# ---- forward projection and reprojection ----


def _moving_uniforms(seed):
    """The camera steps back and turns a little: the previous frame's
    pixels crowd together, so several land on one target."""
    r = np.random.default_rng(seed)
    kw = dict(cam_x=(80.0, 384.0, 140.0), cam_w=(1.0, 0.02, -0.01), cam_u=(0.0, 0.0, 1.0),
              fov_deg=100.0, prev_cam=((160.0, 380.0, 142.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)))
    depth = r.uniform(20.0, 600.0, (H, W)).astype(np.float32)
    mv = r.normal(size=(H, W, 2)).astype(np.float32)
    return j_default_uniforms(**kw), default_uniforms(device="cpu", **kw), depth, mv


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_project_duplicate_targets(seed, monkeypatch):
    ju, tu, depth, mv = _moving_uniforms(seed)
    cfg = RenderConfig(width=W, height=H)
    want = np.asarray(j_vol._forward_project(jnp.asarray(mv), jnp.asarray(depth), ju, JConfig(width=W, height=H)))
    got = t_vol._forward_project(T(mv), T(depth), tu, cfg)
    moved = np.abs(want - mv).max(-1) > 0
    assert 0.2 < moved.mean() < 1.0  # projections land, and some pixels keep the surface MVs
    np.testing.assert_array_equal(np.abs(got.numpy() - mv).max(-1) > 0, moved)  # the same targets
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)  # mv: ulps of a projection
    # the targets were contended: fewer written than projected sources
    assert moved.sum() < ((depth >= 50.0).sum() * 0.95)
    # and the last source writes, whatever order the scatter applies
    from merian_quake_tpu_torch.ops import segments

    plain = segments.scatter_rows
    monkeypatch.setattr(t_vol.segments, "scatter_rows",
                        lambda t, i, r: plain(t, i.flip(0), r.flip(0)))
    assert torch.equal(t_vol._forward_project(T(mv), T(depth), tu, cfg), got)


def test_reproject_and_accumulate_reprojected_match():
    r = np.random.default_rng(11)
    hist = r.uniform(0, 4, (H, W, 4)).astype(np.float32)
    new = r.uniform(0, 4, (H, W, 4)).astype(np.float32)
    hist_len = r.integers(0, 9, (H, W)).astype(np.float32)
    mv = (r.normal(size=(H, W, 2)) * 6.0).astype(np.float32)
    mv[0, :4] = [[-1e6, 0.0], [1e6, 3.0], [0.0, -0.5], [0.25, 1e9]]  # far off the image
    extra = r.random((H, W)) < 0.9
    out, valid = t_acc.reproject(T(hist), T(mv), fallback=T(new))
    j_out, j_valid = j_acc.reproject(jnp.asarray(hist), jnp.asarray(mv), fallback=jnp.asarray(new))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    assert 0.3 < valid.float().mean() < 1.0
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-6, atol=1e-6)
    for kw in (dict(), dict(valid_extra=extra, alpha=0.1), dict(firefly_k=2.0)):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        got = t_acc.accumulate_reprojected(T(hist), T(hist_len), T(new), T(mv),
                                           **{k: T(v) if isinstance(v, np.ndarray) else v
                                              for k, v in kw.items()})
        want = j_acc.accumulate_reprojected(jnp.asarray(hist), jnp.asarray(hist_len),
                                            jnp.asarray(new), jnp.asarray(mv), **jkw)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    clamped = t_acc.firefly_clamp(T(new), 2.0)
    np.testing.assert_allclose(clamped.numpy(), np.asarray(j_acc.firefly_clamp(jnp.asarray(new), 2.0)),
                               rtol=1e-5, atol=1e-6)
    assert (clamped[..., :3] < T(new)[..., :3]).any() and torch.equal(clamped[..., 3], T(new)[..., 3])
