"""SSMM (render/ssmm/ssmm.py): port against JAX package, same numpy inputs.

The chain functions (``_state_new``, ``_sel``, ``_state_dir``,
``_state_add``, ``_state_vmf``, ``_state_score``) on seeded states of 96
chains, some empty, some at ``ml_max_n``: equal or within rtol 1e-5
(``_state_vmf``'s kappa grows as 1/(1 - r) and the cosine power of
``_state_score`` is 64, so a last-place ulp of r or of a cosine moves
them by up to ~64 ulps).

One ``render_ssmm`` pass, 2 spp, on cornell_box from the JAX package's
own gbuffer and SSMM state (three jitted JAX frames warm the chains),
carried across by ``interop``, at 64×36 (buffer order row-major) and at
256×8 (``layout.is_tiled``: two 8×128 tiles side by side, so that the
buffer order is not the image's; at 128×16 the tiles stack and the two
orders coincide). The JAX pass runs op by op, as its package's tests run
it (no multiply-add contracted on either side). Read at both sizes: the
irradiance image within 1e-3 on 100% of pixels, mean |Δ| 9.0e-9 and
1.0e-8, every chain's N equal and its sum_w, f and sum_len within rtol
1e-4. Bounds: the image within 1e-3 on ≥ 99.5% of pixels, mean |Δ| <
1e-5; the floats within rtol 1e-4 on ≥ 99.5% of chains; N equal on every
chain. The last is exact because the two orders of the roll differ only
where a buffer row of a tile starts (x % 128 = 0, 1 pixel in 128), and
there the rolled chain is mostly outscored by the stochastic reads: the
image-order mutant moves 1 of 2,048 chains at 256×8 and no pixel. Two
mutants fail the bounds: the lane shuffle's roll in the other direction
(both sizes: 87-88% of N equal, 89-91% of pixels), and the roll in image
order, which fails at 256×8 and, as it must, passes at 64×36, where the
two orders are one.

The end-to-end check of tests/test_ssmm.py runs on the port: 12 frames
of ``ssmm`` at 2 spp on cornell_box within 15% of a 4 spp PT reference's
mean, with a lower relMSE than PT at the same spp, and a learned state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu import renderer as j_renderer
from merian_quake_tpu.accel.build import build_accel as j_build_accel
from merian_quake_tpu.accel.build import scene_features as j_scene_features
from merian_quake_tpu.models.procedural import cornell_box as j_box
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.render.gbuffer import render_gbuffer as j_render_gbuffer
from merian_quake_tpu.render.ssmm import ssmm as j_ssmm
from merian_quake_tpu_torch import interop
from merian_quake_tpu_torch.accel.build import build_accel, scene_features
from merian_quake_tpu_torch.models.procedural import cornell_box, get_scene
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.render import layout
from merian_quake_tpu_torch.render.ssmm import SSMMConfig
from merian_quake_tpu_torch.render.ssmm import ssmm as t_ssmm
from merian_quake_tpu_torch.renderer import render_sequence
from torch_denoise_cases import torch_with

torch.set_num_threads(min(2, torch.get_num_threads()))

CFG, J_CFG = SSMMConfig(), j_ssmm.SSMMConfig()


# ---- the chain functions ----

def _chains(n=96, seed=0):
    r = np.random.default_rng(seed)
    N = r.integers(0, 1500, n).astype(np.int32)
    N[:8] = 0
    N[8:16] = CFG.ml_max_n
    sum_w = r.uniform(0, 4, n).astype(np.float32)
    sum_w[:8] = 0.0
    mean_cos = r.uniform(0, 1, n)
    mean_cos[16:24] = 1.0 - 10.0 ** -r.uniform(2, 7, 8)  # sharp lobes
    state = dict(sum_tgt=r.normal(0, 50, (n, 3)).astype(np.float32), sum_w=sum_w, N=N,
                 sum_len=(sum_w * mean_cos).astype(np.float32),
                 f=r.exponential(1.0, n).astype(np.float32))
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    extra = dict(x=r.normal(0, 5, (n, 3)).astype(np.float32), w=r.exponential(1.0, n).astype(np.float32),
                 d=d, y=r.normal(0, 80, (n, 3)).astype(np.float32),
                 mask=r.random(n) < 0.5)
    return state, extra


def _both(state):
    j = j_ssmm.SSMMState(**{k: jnp.asarray(v) for k, v in state.items()})
    return j, interop.ssmm_state_from_numpy(j, device="cpu")


def _close(ours, ref, rtol=0.0):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype and np.isfinite(ours).all()
    if rtol:
        np.testing.assert_allclose(ours, ref, rtol=rtol, atol=1e-6)
    else:
        np.testing.assert_array_equal(ours, ref)


def _states_close(ours, ref, rtol=0.0):
    for f in t_ssmm.SSMMState._fields:
        _close(getattr(ours, f), getattr(ref, f), 0.0 if f == "N" else rtol)


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_functions_match_jax(seed):
    state, e = _chains(seed=seed)
    js, ts = _both(state)
    jx, tx = (jnp.asarray(e["x"]), torch.from_numpy(e["x"]))
    _states_close(t_ssmm._state_new(5, device="cpu"), j_ssmm._state_new(5))
    other = _both(_chains(seed=seed + 10)[0])
    _states_close(t_ssmm._sel(torch.from_numpy(e["mask"]), ts, other[1]),
                  j_ssmm._sel(jnp.asarray(e["mask"]), js, other[0]))
    _close(t_ssmm._state_dir(ts, tx), j_ssmm._state_dir(js, jx), 1e-5)
    args = [e[k] for k in ("w", "d", "y")]
    _states_close(t_ssmm._state_add(ts, tx, *map(torch.from_numpy, args), CFG),
                  j_ssmm._state_add(js, jx, *map(jnp.asarray, args), J_CFG), 1e-5)
    (tm, tk), (jm, jk) = t_ssmm._state_vmf(ts, tx, CFG), j_ssmm._state_vmf(js, jx, J_CFG)
    _close(tm, jm, 1e-5)
    _close(tk, jk, 1e-5)
    assert float(tk.max()) > 100.0 and float(tk.min()) < 1.0  # sharp and diffuse lobes
    r = np.random.default_rng(seed + 20)
    normal_img = r.normal(size=(200, 3)).astype(np.float32)
    normal_img /= np.linalg.norm(normal_img, axis=-1, keepdims=True)
    z_img = r.uniform(0, 100, 200).astype(np.float32)
    idx = r.integers(0, 200, 96)
    cam = np.asarray([1.0, 2.0, 3.0], np.float32)
    _close(t_ssmm._state_score(ts, tx, torch.from_numpy(e["d"]), torch.from_numpy(normal_img),
                               torch.from_numpy(z_img), torch.from_numpy(cam), torch.from_numpy(idx)),
           j_ssmm._state_score(js, jx, jnp.asarray(e["d"]), jnp.asarray(normal_img),
                               jnp.asarray(z_img), jnp.asarray(cam), jnp.asarray(idx)), 1e-5)


def test_state_add_learns_direction():
    s = t_ssmm._state_new(4, device="cpu")
    x = torch.zeros((4, 3))
    y = torch.tensor([100.0, 0.0, 0.0]).expand(4, 3)
    d = torch.tensor([1.0, 0.0, 0.0]).expand(4, 3)
    for _ in range(20):
        s = t_ssmm._state_add(s, x, torch.full((4,), 2.0), d, y, CFG)
    mu, kappa = t_ssmm._state_vmf(s, x, CFG)
    np.testing.assert_allclose(mu[0].numpy(), [1.0, 0.0, 0.0], atol=1e-4)
    assert float(kappa[0]) > 50.0 and int(s.N[0]) == 20


def test_state_add_mixed_directions_low_kappa():
    s = t_ssmm._state_new(1, device="cpu")
    x = torch.zeros((1, 3))
    for i in range(40):
        sign = 1.0 if i % 2 == 0 else -1.0
        s = t_ssmm._state_add(s, x, torch.ones((1,)), torch.tensor([[0.0, sign, 0.0]]),
                              torch.tensor([[0.0, sign * 100.0, 1.0]]), CFG)
    assert float(t_ssmm._state_vmf(s, x, CFG)[1][0]) < 5.0


# ---- one render_ssmm pass on carried state ----

class Warm:
    """Three jitted JAX SSMM frames of cornell_box, then frame 3's gbuffer
    and the chains go to both packages; the JAX pass runs op by op."""

    def __init__(self, w, h):
        self.w, self.h = w, h
        b = j_box()
        acc = j_build_accel(b.scene, b.atlas)
        jcfg = JConfig(width=w, height=h, spp=2, integrator="ssmm",
                       features=j_scene_features(b.scene, b.uniforms, b.atlas))
        st = j_renderer.init_state(jcfg, J_CFG)
        step = jax.jit(lambda u, s: j_renderer.frame_core(acc, b.atlas, u, jcfg, s, mcpg_config=J_CFG)[0])
        for i in range(3):
            st = step(b.uniforms._replace(frame=jnp.uint32(i)), st)
        uni = b.uniforms._replace(frame=jnp.uint32(3))
        gbuf = jax.jit(lambda u: j_render_gbuffer(acc, b.atlas, u, jcfg))(uni)
        with jax.disable_jit():
            self.j_out = j_ssmm.render_ssmm(acc, b.atlas, uni, jcfg, J_CFG, st.ssmm, gbuf)
        tb = cornell_box(device="cpu")
        self.bundle, self.accel = tb, build_accel(tb.scene, tb.atlas, device="cpu")
        self.cfg = RenderConfig(width=w, height=h, spp=2, integrator="ssmm",
                                features=scene_features(tb.scene, tb.uniforms, tb.atlas))
        self.uni = interop.uniforms_from_numpy(uni, "cpu")
        self.gbuf = interop.gbuffer_from_numpy(gbuf, "cpu")
        self.sstate = interop.ssmm_state_from_numpy(st.ssmm, "cpu")

    def port(self):
        return t_ssmm.render_ssmm(self.accel, self.bundle.atlas, self.uni, self.cfg, CFG,
                                  self.sstate, self.gbuf)


SIZES = {"64x36": (64, 36), "256x8 tiled": (256, 8)}


@pytest.fixture(scope="module", params=list(SIZES))
def warm(request):
    return Warm(*SIZES[request.param])


def _pass_agrees(out, j_out):
    img, state = out
    j_img, j_state = j_out
    img, j_img = img.numpy(), np.asarray(j_img)
    assert img.shape == j_img.shape and np.isfinite(img).all()
    d = np.abs(img - j_img)
    assert (d.max(-1) <= 1e-3).mean() >= 0.995, (d.max(-1) <= 1e-3).mean()
    assert d.mean() < 1e-5, d.mean()
    np.testing.assert_array_equal(state.N.numpy(), np.asarray(j_state.N))
    for f in ("sum_w", "f", "sum_len"):
        ok = np.isclose(getattr(state, f).numpy(), np.asarray(getattr(j_state, f)), rtol=1e-4, atol=1e-6)
        assert ok.mean() >= 0.995, (f, ok.mean())


def test_render_ssmm_pass_on_carried_state(warm):
    assert layout.is_tiled(warm.w, warm.h) == (warm.w == 256)
    out = warm.port()
    _pass_agrees(out, warm.j_out)
    img, state = out
    assert float(img[..., :3].mean()) > 0.01
    learned = state.sum_w > 0
    assert learned.float().mean() > 0.3 and not torch.equal(state.sum_w, warm.sstate.sum_w)


def _image_order_roll(w, h):
    """torch.roll over the image's row-major order (a mutant of the roll
    over the flat buffer)."""
    def roll(x, shift, dim):
        img = layout.flat_to_image(x, w, h)
        rolled = torch.roll(img.reshape((w * h,) + tuple(x.shape[1:])), shift, 0)
        return layout.image_to_flat(rolled.reshape(img.shape), w, h)
    return roll


@pytest.mark.parametrize("mutant", ["roll flipped", "roll in image order"])
def test_render_ssmm_mutant_fails(warm, monkeypatch, mutant):
    roll = ((lambda x, s, d: torch.roll(x, -s, d)) if mutant == "roll flipped"
            else _image_order_roll(warm.w, warm.h))
    monkeypatch.setattr(t_ssmm, "torch", torch_with(roll=roll))
    if mutant == "roll in image order" and not layout.is_tiled(warm.w, warm.h):
        _pass_agrees(warm.port(), warm.j_out)  # the two orders coincide
        return
    with pytest.raises(AssertionError):
        _pass_agrees(warm.port(), warm.j_out)


# ---- the twin of tests/test_ssmm.py's end-to-end check, on the port ----

def test_ssmm_end_to_end_unbiased_and_lower_noise():
    w, h = 40, 24
    run = lambda **kw: render_sequence(get_scene("box", device="cpu"), RenderConfig(width=w, height=h, **kw),
                                       frames=12, device="cpu")[0]
    ref = run(spp=4, max_path_length=2, seed=5).accum_irradiance[..., :3].numpy()
    st = run(spp=2, seed=7, integrator="ssmm")
    est = st.accum_irradiance[..., :3].numpy()
    assert np.isfinite(est).all()
    assert abs(est.mean() - ref.mean()) / ref.mean() < 0.15
    base = run(spp=2, max_path_length=2, seed=7).accum_irradiance[..., :3].numpy()
    rel = lambda e: float(((e - ref) ** 2 / (ref**2 + 1e-2)).mean())
    assert rel(est) < rel(base), (rel(est), rel(base))
    assert float(st.ssmm.sum_w.max()) > 0.0
