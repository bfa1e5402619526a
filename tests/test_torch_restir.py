"""The port's ReSTIR DI against the JAX package's, on the same inputs.

Reservoir functions: M and y_flags equal, floats to rtol 1e-6 (the
selection test ``u·w_sum < w`` sees the same uniforms and the same one
add on both sides). ``_seed`` bit for bit.

One frame. XLA fuses multiply-adds on the CPU and PyTorch does not; one
ulp in a reservoir's weight can flip a selection (``u·w_sum < w``) and
send that pixel's sample elsewhere. So the frame is held by the share of
pixels that agree and by the mean difference. One ``render_restir``
frame of city at 48×27 starts from the JAX package's state after 2
frames (carried across by ``interop``), with the camera moved (6, −4, 1)
so that reprojection, its gathers and the bias corrections act. Every
bound is set from the JAX package's own reading of its jitted run
against an op-by-op run (``jax.disable_jit``, which fuses no
multiply-adds either) on the same pixels: its share less about 2 pixels
of 1,296, and 1.25× its mean. Readings (JAX jit vs op-by-op → port vs
jit): irradiance within 1e-3 on 99.691% of pixels, mean |Δ| 2.75e-4 →
99.691%, 1.62e-4 (defaults and bias correction 2 alike); with the
boiling filter at strength 1: 99.769%, 1.98e-4 → 99.769%, 8.5e-5; W
within rtol 1e-4 on 99.691% (boiling: 99.769%) on both; M and y_flags
equal everywhere on both. Bounds: ≥ 99.5% and < 3.5e-4; W ≥ 99.5%;
y_flags ≥ 99.5%; M equal. The remaining branches in one case (2
candidates, ``apply_mv``, bias correction 1, M clamp 2, 2 spatial
iterations; more selections, so more flips): 98.997%, 5.79e-4 →
98.997%, 5.48e-4, W 98.997% on both; bounds ≥ 98.8% (share, W and
y_flags) and < 7.2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.accel.build import build_accel as j_build_accel
from merian_quake_tpu.accel.build import scene_features as j_scene_features
from merian_quake_tpu.models.procedural import city as j_city
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.render.gbuffer import render_gbuffer as j_render_gbuffer
from merian_quake_tpu.render.restir import ReSTIRConfig as JReSTIRConfig
from merian_quake_tpu.render.restir import render_restir as j_render_restir
from merian_quake_tpu.render.restir import reservoir as j_rsv
from merian_quake_tpu.render.restir.restir import _seed as j_seed
from merian_quake_tpu.renderer import init_state as j_init_state
from merian_quake_tpu.renderer import render_frame as j_render_frame
from merian_quake_tpu_torch import interop
from merian_quake_tpu_torch.accel import build_accel
from merian_quake_tpu_torch.models.types import RenderConfig, SceneFeatures
from merian_quake_tpu_torch.ops import rng as t_rng
from merian_quake_tpu_torch.render.restir import ReSTIRConfig, render_restir
from merian_quake_tpu_torch.render.restir import reservoir as rsv
from merian_quake_tpu_torch.render.restir.restir import _seed

# The suite runs several test processes side by side on a few cores;
# torch would start one thread per core in each and oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

W, H = 48, 27


def _t(x):
    """An array as a CPU tensor (the interop default is the card)."""
    return interop.tensor(x, device="cpu")


def _u32(x):
    return np.asarray(x).astype(np.uint32)


def _agree(ours, ref, share, mean, pixels=None, tol=1e-3):
    """Share of pixels within ``tol`` (max over channels) and mean |Δ|."""
    ours, ref = ours.float().numpy(), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    d = np.abs(ours - ref)
    per_pixel = d.max(-1) if d.ndim == 3 else d
    if pixels is not None:
        d, per_pixel = d[pixels], per_pixel[pixels]
    assert (per_pixel <= tol).mean() >= share, (per_pixel <= tol).mean()
    assert d.mean() < mean, d.mean()


def _rel_share(ours, ref, rtol=1e-4):
    ours, ref = ours.numpy(), np.asarray(ref)
    return (np.abs(ours - ref) <= rtol * np.maximum(np.abs(ref), 1e-30)).mean()


# ------------------------------------------------------------ reservoirs


def _random_reservoir(gen, n):
    """Reservoir fields as numpy arrays (u32 flags)."""
    f = lambda *s: gen.uniform(0.0, 2.0, s).astype(np.float32)
    return (gen.integers(0, 40, n).astype(np.int32), f(n), f(n), f(n, 3), f(n, 3), f(n, 3),
            f(n), f(n, 3), gen.integers(0, 2, n).astype(np.uint32))


def _both(fields):
    return (j_rsv.Reservoir(*[jnp.asarray(x) for x in fields]),
            rsv.Reservoir(*[_t(x) for x in fields]))


def _assert_reservoirs(ours, ref):
    np.testing.assert_array_equal(ours.M.numpy(), np.asarray(ref.M))
    np.testing.assert_array_equal(_u32(ours.y_flags), np.asarray(ref.y_flags))
    assert ours.M.dtype == torch.int32 and ours.y_flags.dtype == torch.int64
    for f in ("w", "p_target", "y_pos", "y_normal", "y_mv", "y_T", "y_radiance"):
        np.testing.assert_allclose(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), rtol=1e-6)


def test_reservoir_functions_match_jax(rng):
    n = 4096
    jr, tr = _both(_random_reservoir(rng, n))
    _assert_reservoirs(tr, jr)
    jo, to = _both(_random_reservoir(rng, n))
    state = rng.integers(1, 2**32, n, dtype=np.uint64)
    js, ts = jnp.asarray(state.astype(np.uint32)), _t(state.astype(np.int64))
    mask = rng.uniform(size=n) < 0.7
    p_sample = rng.uniform(0.0, 1.0, n).astype(np.float32)
    p_sample[:64] = 0.0  # the 1e-20 floor
    p_tgt = rng.uniform(0.0, 3.0, n).astype(np.float32)
    pos, nrm, mv, rad = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(4))
    T = rng.uniform(0, 10, n).astype(np.float32)
    flags = np.full(n, j_rsv.FLAG_VALID, np.uint32)
    sample = (mask, pos, nrm, mv, T, rad, flags, p_sample, p_tgt)

    js, jr2, jtake = j_rsv.add_sample(jr, js, *[jnp.asarray(x) for x in sample])
    ts, tr2, ttake = rsv.add_sample(tr, ts, *[_t(x) for x in sample])
    np.testing.assert_array_equal(_u32(ts), np.asarray(js))
    np.testing.assert_array_equal(ttake.numpy(), np.asarray(jtake))
    assert 0 < ttake.numpy().mean() < 1
    _assert_reservoirs(tr2, jr2)

    for m in (None, rng.uniform(size=n) < 0.5):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else _t(m)
        js, jc, jtake = j_rsv.combine_finalized(jr2, js, jo, jnp.asarray(p_tgt), jm)
        ts, tc, ttake = rsv.combine_finalized(tr2, ts, to, _t(p_tgt), tm)
        np.testing.assert_array_equal(ttake.numpy(), np.asarray(jtake))
        _assert_reservoirs(tc, jc)
    _assert_reservoirs(rsv.finalize(tc), j_rsv.finalize(jc))
    num, den = rng.uniform(0, 2, n).astype(np.float32), rng.uniform(-1, 40, n).astype(np.float32)
    _assert_reservoirs(rsv.finalize_custom(tc, _t(num), _t(den)),
                       j_rsv.finalize_custom(jc, jnp.asarray(num), jnp.asarray(den)))
    _assert_reservoirs(rsv.discard(tc, _t(mask)), j_rsv.discard(jc, jnp.asarray(mask)))
    np.testing.assert_array_equal(rsv.valid(tc).numpy(), np.asarray(j_rsv.valid(jc)))


def test_reservoir_add_sample_probabilities():
    """Twin of test_restir.py:23: WRS selects sample i with probability
    w_i / sum(w)."""
    n = 20000
    r = rsv.reservoir_init(n, device="cpu")
    state = t_rng.seed_pixel(torch.arange(n, dtype=torch.int64), 0, 0, 3)
    weights = [1.0, 3.0, 6.0]
    for i, w in enumerate(weights):
        state, r, _ = rsv.add_sample(
            r, state, torch.ones(n, dtype=torch.bool), torch.full((n, 3), float(i)),
            torch.zeros(n, 3), torch.zeros(n, 3), torch.zeros(n), torch.ones(n, 3),
            torch.full((n,), rsv.FLAG_VALID, dtype=torch.int64), torch.ones(n), torch.full((n,), w),
        )
    assert int(r.M[0]) == 3
    np.testing.assert_allclose(r.w.numpy(), sum(weights), rtol=1e-6)
    picked = r.y_pos[:, 0].numpy()
    for i, w in enumerate(weights):
        np.testing.assert_allclose((picked == i).mean(), w / sum(weights), atol=0.02)


def test_reservoir_finalize():
    """Twin of test_restir.py:51."""
    n = 4
    r = rsv.reservoir_init(n, device="cpu")._replace(
        M=torch.full((n,), 5, dtype=torch.int32), w=torch.full((n,), 10.0),
        p_target=torch.full((n,), 2.0),
    )
    np.testing.assert_allclose(rsv.finalize(r).w.numpy(), 10.0 / (5 * 2.0))
    z = rsv.finalize(r._replace(p_target=torch.zeros(n)))
    np.testing.assert_allclose(z.w.numpy(), 0.0)


@pytest.mark.parametrize("frame", [0, 1, 5, 2**30 + 3, 2**32 - 1])
def test_seed_bit_exact(frame):
    """frame·4 + pass as u32 (wraps for frames ≥ 2^30)."""
    py, px = np.meshgrid(np.arange(9), np.arange(13), indexing="ij")
    px, py = px.reshape(-1).astype(np.int32), py.reshape(-1).astype(np.int32)
    for pass_idx in range(3):
        ref = j_seed(jnp.asarray(px), jnp.asarray(py), jnp.uint32(frame), pass_idx, jnp.uint32(1337))
        np.testing.assert_array_equal(_u32(_seed(_t(px), _t(py), frame, pass_idx, 1337)), np.asarray(ref))


# ------------------------------------------------------------ frames


@pytest.fixture(scope="module")
def jax_city():
    """The JAX package's city state after 2 frames, rendered frame by frame
    as its render_sequence does it: the carried-over input of frame 2."""
    bundle = j_city()
    accel = j_build_accel(bundle.scene, bundle.atlas)
    cfg = JConfig(width=W, height=H, integrator="restir",
                  features=j_scene_features(bundle.scene, bundle.uniforms, bundle.atlas))
    rcfg = JReSTIRConfig()
    state = j_init_state(cfg, rcfg)
    for i in range(2):
        state, _ = j_render_frame(accel, bundle.atlas, bundle.uniforms._replace(frame=jnp.uint32(i)),
                                  cfg, state, rcfg)
    jax.block_until_ready(state.restir.reservoirs.w)
    return bundle, accel, cfg, state


@pytest.mark.parametrize("kw,share,mean", [
    ({}, 0.995, 3.5e-4),
    ({"temporal_bias_correction": 2, "spatial_bias_correction": 2}, 0.995, 3.5e-4),
    ({"boiling_filter_strength": 1.0}, 0.995, 3.5e-4),
    ({"spp": 2, "apply_mv": True, "temporal_bias_correction": 1, "spatial_bias_correction": 1,
      "temporal_clamp_m": 2, "spatial_reuse_iterations": 2}, 0.988, 7.2e-4),
], ids=["defaults", "bias2", "boiling", "spp2_mv_bias1_clamp"])
def test_render_restir_frame_from_carried_state(jax_city, kw, share, mean):
    bundle, j_accel, cfg, mid_state = jax_city
    u = bundle.uniforms
    uniforms = u._replace(frame=jnp.uint32(2), cam_x=u.cam_x + jnp.asarray([6.0, -4.0, 1.0]),
                          prev_cam_x=u.cam_x)
    gbuf = jax.jit(j_render_gbuffer, static_argnums=(3,))(j_accel, bundle.atlas, uniforms, cfg)
    ref_irr, ref_state = jax.jit(j_render_restir, static_argnums=(3, 4))(
        j_accel, bundle.atlas, uniforms, cfg, JReSTIRConfig(**kw), mid_state.restir, gbuf,
    )
    atlas = interop.atlas_from_numpy(bundle.atlas, device="cpu")
    accel = build_accel(interop.scene_from_numpy(bundle.scene, device="cpu"), atlas)
    irr, state = render_restir(
        accel, atlas, interop.uniforms_from_numpy(uniforms, device="cpu"),
        RenderConfig(width=W, height=H, integrator="restir", features=SceneFeatures(*cfg.features)),
        ReSTIRConfig(**kw), interop.restir_state_from_numpy(mid_state.restir, device="cpu"),
        interop.gbuffer_from_numpy(gbuf, device="cpu"),
    )
    _agree(irr, ref_irr, share, mean)
    assert (irr[..., :3].amax(-1) > 0).float().mean() > 0.5  # lit, not an empty frame
    np.testing.assert_array_equal(state.reservoirs.M.numpy(), np.asarray(ref_state.reservoirs.M))
    assert _rel_share(state.reservoirs.w, ref_state.reservoirs.w) >= share
    assert (_u32(state.reservoirs.y_flags) == np.asarray(ref_state.reservoirs.y_flags)).mean() >= share
    np.testing.assert_array_equal(state.prev_normal.numpy(), np.asarray(ref_state.prev_normal))
