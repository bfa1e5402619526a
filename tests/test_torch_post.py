"""The denoise and beauty chain (post/svgf.py, taa.py, fxaa.py,
exposure.py): port against JAX package, same numpy inputs.

Twins of tests/test_post.py (flat-region denoising, depth edges, TAA
clamping, FXAA on a staircase) on the port, and every function held
against the JAX function on seeded 32×24 inputs with two depth planes,
a normal flip down the middle, per-pixel normal noise and motion vectors
that leave the frame on the top rows. The JAX functions run as
tests/test_post.py calls them, op by op (XLA fuses nothing, so neither
side contracts a multiply-add):

- ``temporal`` (its integrated irradiance, variance and every state
  field), ``taa``, ``fxaa`` and ``manual_exposure``: equal (read: equal);
- ``atrous_iteration`` (steps 1-16), ``svgf_filter`` and ``svgf`` (three
  frames from an empty state): rtol 1e-5, atol 1e-6 (read: at most
  5.6e-7 relative). The loose part is the filter's weights: the normal
  weight is a cosine to the 128th power and the luminance weight an
  exponential over sigma_l·sqrt(prefiltered variance), which is 0 on the
  zero-variance block of the inputs, so an ulp of a cosine or a
  luminance moves a weight by ~128 ulps or more;
- ``auto_exposure``: rtol 1e-6 (the log-mean is a reduction, summed in
  another order by each package).

A jitted JAX run differs from its op-by-op run by more: FXAA's edge
decisions turn on an ulp (0.31 in one pixel), so the frames are held in
tests/test_torch_denoise_slice.py to the JAX package's own spread. Each
bound has a mutant that fails it: the à-trous step not doubling, the
spatial variance fallback dropped, TAA blending toward the history (0.9
for 0.1), FXAA's relative threshold ignored, the exposure key ignored.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.post import exposure as j_exp
from merian_quake_tpu.post import fxaa as j_fxaa
from merian_quake_tpu.post import svgf as j_svgf
from merian_quake_tpu.post import taa as j_taa
from merian_quake_tpu_torch import interop
from merian_quake_tpu_torch.post import exposure as t_exp
from merian_quake_tpu_torch.post import fxaa as t_fxaa
from merian_quake_tpu_torch.post import svgf as t_svgf
from merian_quake_tpu_torch.post import taa as t_taa
from torch_denoise_cases import torch_with

torch.set_num_threads(min(2, torch.get_num_threads()))

H, W = 24, 32
P = t_svgf.SVGFParams()
JP = j_svgf.SVGFParams()
FILTER_TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed):
    r = np.random.default_rng(seed)
    irr = r.gamma(1.0, 0.5, (H, W, 3)).astype(np.float32)
    mom = (irr.mean(-1) ** 2 * r.uniform(1, 3, (H, W))).astype(np.float32)
    mv = r.normal(0, 1.5, (H, W, 2)).astype(np.float32)
    mv[:4] += 40.0  # these rows reproject from outside the frame
    n = np.zeros((H, W, 3), np.float32)
    n[..., 2] = 1.0
    n[:, W // 2:] = [1.0, 0.0, 0.0]  # a normal flip
    n += r.normal(0, 0.05, n.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    z = np.where(np.arange(W)[None] < W // 3, 50.0, 500.0) * np.ones((H, 1))  # a depth edge
    z = (z + r.uniform(0, 1, (H, W))).astype(np.float32)
    zg = r.uniform(0, 2, (H, W, 2)).astype(np.float32)
    alb = r.uniform(0, 1, (H, W, 3)).astype(np.float32)
    var = r.uniform(0, 0.3, (H, W)).astype(np.float32)
    var[5:10, 5:10] = 0.0  # a zero-variance block
    ldr = r.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return dict(irr=irr, mom=mom, mv=mv, n=n, z=z, zg=zg, alb=alb, var=var, ldr=ldr)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(ours, ref, **tol):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    if tol:
        np.testing.assert_allclose(ours, ref, **tol)
    else:
        np.testing.assert_array_equal(ours, ref)


def _warm_states(x, frames=2):
    """A JAX SVGF state after ``frames`` frames, and the port's copy."""
    js = j_svgf.init_svgf_state(H, W)
    for k in range(frames):
        y = _inputs(100 + k)
        js, _ = j_svgf.svgf(js, *map(_j, (y["irr"], y["mom"], x["mv"], x["n"], x["z"], x["zg"],
                                           x["alb"])))
    return js, interop.svgf_state_from_numpy(js, device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_temporal_matches_jax(seed):
    x = _inputs(seed)
    js, ts = _warm_states(x)
    args = ("irr", "mom", "mv", "n", "z", "zg")
    jn, ji, jv = j_svgf.temporal(js, *[_j(x[k]) for k in args], JP)
    tn, ti, tv = t_svgf.temporal(ts, *[_t(x[k]) for k in args], P)
    _close(ti, ji)
    _close(tv, jv)
    for f in t_svgf.SVGFState._fields:
        _close(getattr(tn, f), getattr(jn, f))
    hist = tn.history_len.numpy()
    assert (hist == 1.0).mean() > 0.1 and (hist > 1.0).mean() > 0.3  # both branches taken


@pytest.mark.parametrize("step", [1, 2, 4, 8, 16])
def test_atrous_iteration_matches_jax(step):
    x = _inputs(step)
    args = ("irr", "var", "n", "z", "zg")
    ji, jv = j_svgf.atrous_iteration(*[_j(x[k]) for k in args], step, JP)
    ti, tv = t_svgf.atrous_iteration(*[_t(x[k]) for k in args], step, P)
    _close(ti, ji, **FILTER_TOL)
    _close(tv, jv, **FILTER_TOL)


def test_svgf_filter_matches_jax():
    x = _inputs(7)
    args = ("irr", "var", "n", "z", "zg")
    _close(t_svgf.svgf_filter(*[_t(x[k]) for k in args], P),
           j_svgf.svgf_filter(*[_j(x[k]) for k in args], JP), **FILTER_TOL)


def test_svgf_three_frames_match_jax():
    x = _inputs(11)
    js = j_svgf.init_svgf_state(H, W)
    ts = t_svgf.init_svgf_state(H, W, device="cpu")
    for k in range(3):
        y = _inputs(200 + k)
        frame = (y["irr"], y["mom"], x["mv"], x["n"], x["z"], x["zg"], x["alb"])
        js, jout = j_svgf.svgf(js, *map(_j, frame))
        ts, tout = t_svgf.svgf(ts, *map(_t, frame))
        _close(tout, jout, **FILTER_TOL)
        for f in t_svgf.SVGFState._fields:
            _close(getattr(ts, f), getattr(js, f), **FILTER_TOL)


def test_taa_matches_jax():
    x = _inputs(3)
    prev = _inputs(4)["ldr"]
    _close(t_taa.taa(_t(prev), _t(x["ldr"]), _t(x["mv"])),
           j_taa.taa(_j(prev), _j(x["ldr"]), _j(x["mv"])))


@pytest.mark.parametrize("img", ["ldr", "staircase"])
def test_fxaa_matches_jax(img):
    rgb = _inputs(5)["ldr"]
    if img == "staircase":
        rgb = np.zeros((H, W, 3), np.float32)
        for y in range(H):
            rgb[y, : y // 2] = 1.0
    _close(t_fxaa.fxaa(_t(rgb)), j_fxaa.fxaa(_j(rgb)))


def test_exposure_matches_jax():
    img = np.concatenate([_inputs(6)["irr"], np.ones((H, W, 1), np.float32)], -1)
    t_rgb, t_scale = t_exp.auto_exposure(_t(img))
    j_rgb, j_scale = j_exp.auto_exposure(_j(img))
    _close(t_rgb, j_rgb, rtol=1e-6)
    _close(t_scale, j_scale, rtol=1e-6)
    t_rgb, t_scale = t_exp.manual_exposure(_t(img), 2.5)
    j_rgb, j_scale = j_exp.manual_exposure(_j(img), 2.5)
    _close(t_rgb, j_rgb)
    assert float(t_scale) == float(j_scale) == 2.5


def _mutant(name, monkeypatch):
    """Install one mutant of the port's chain; return the check it fails."""
    if name == "atrous step not doubling":
        plain = t_svgf.atrous_iteration
        monkeypatch.setattr(t_svgf, "atrous_iteration",
                            lambda i, v, n, z, zg, step, p: plain(i, v, n, z, zg, 1, p))
        return test_svgf_filter_matches_jax
    if name == "spatial variance fallback dropped":
        # temporal's one torch.maximum is max(var_t, var_s)
        monkeypatch.setattr(t_svgf, "torch", torch_with(maximum=lambda a, b: a))
        return lambda: test_temporal_matches_jax(0)
    if name == "taa blend toward the history":
        monkeypatch.setattr(t_taa.taa, "__defaults__", (0.9,))
        return test_taa_matches_jax
    if name == "fxaa relative threshold ignored":
        monkeypatch.setattr(t_fxaa.fxaa, "__defaults__", (0.0312, 0.0))
        return lambda: test_fxaa_matches_jax("ldr")
    if name == "exposure key ignored":
        monkeypatch.setattr(t_exp.auto_exposure, "__defaults__", (1.0, 1e-4))
        return test_exposure_matches_jax
    raise KeyError(name)


@pytest.mark.parametrize("name", ["atrous step not doubling", "spatial variance fallback dropped",
                                  "taa blend toward the history", "fxaa relative threshold ignored",
                                  "exposure key ignored"])
def test_mutant_fails_its_bound(name, monkeypatch):
    check = _mutant(name, monkeypatch)
    with pytest.raises(AssertionError):
        check()


# ---- twins of tests/test_post.py on the port ----

def test_svgf_denoises_flat_region():
    r = np.random.default_rng(1337)
    h, w = 64, 64
    noise = torch.from_numpy(r.gamma(1.0, 0.5, (h, w, 3)).astype(np.float32))
    state = t_svgf.init_svgf_state(h, w, device="cpu")
    normal = torch.tensor([0.0, 0.0, 1.0]).expand(h, w, 3)
    m2 = (noise.sum(-1) / 3) ** 2
    state, out = t_svgf.svgf(state, noise, m2, torch.zeros((h, w, 2)), normal,
                             torch.full((h, w), 100.0), torch.zeros((h, w, 2)), torch.ones((h, w, 3)))
    assert float(out.std()) < float(noise.std()) * 0.25
    assert abs(float(out.mean()) - float(noise.mean())) < 0.05  # energy preserved


def test_svgf_preserves_depth_edge():
    r = np.random.default_rng(1337)
    h, w = 32, 64
    irr = torch.cat([torch.full((h, w // 2, 3), 0.2), torch.full((h, w // 2, 3), 0.9)], dim=1)
    irr = irr + torch.from_numpy(r.normal(0, 0.05, (h, w, 3)).astype(np.float32))
    z = torch.cat([torch.full((h, w // 2), 50.0), torch.full((h, w // 2), 500.0)], dim=1)
    state = t_svgf.init_svgf_state(h, w, device="cpu")
    normal = torch.tensor([0.0, 0.0, 1.0]).expand(h, w, 3)
    _, out = t_svgf.svgf(state, irr, (irr.sum(-1) / 3) ** 2, torch.zeros((h, w, 2)), normal, z,
                         torch.zeros((h, w, 2)), torch.ones((h, w, 3)))
    assert float(out[:, w // 2 + 4:].mean() - out[:, : w // 2 - 4].mean()) > 0.5  # edge survived


def test_taa_converges_and_clamps():
    out = t_taa.taa(torch.full((16, 16, 3), 0.9), torch.full((16, 16, 3), 0.5), torch.zeros((16, 16, 2)))
    np.testing.assert_allclose(out.numpy(), 0.5, atol=1e-6)


def test_fxaa_smooths_staircase():
    img = torch.zeros((32, 32, 3))
    for y in range(32):
        img[y, : y // 2] = 1.0
    out = t_fxaa.fxaa(img).numpy()
    assert ((out > 0.05) & (out < 0.95)).mean() > 0.005
    np.testing.assert_allclose(out[:, -4:], 0.0, atol=1e-6)
