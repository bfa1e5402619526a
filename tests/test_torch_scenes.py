"""The other procedural scenes: outdoor court, alcove, furnace.

The numpy host build is the JAX package's, so every array equals the
reference's: the triangles and their attributes, the texture bytes, the
atlas table, and the uniforms (the court's fog: ``mu_t``, ``mu_s``,
``volume_max_t``). The atlas's linear f32 texels are within 2 ulps
(read: 1 ulp on 8.3% of the court's): the JAX package decodes sRGB with
XLA's ``pow``, the port with numpy's. Twins of tests/test_render_e2e.py:26-50 hold the
furnace's energy, direct light and albedo on the port alone.

The furnace's direct light is 1 on every pixel but 2 of 576 at 32×18:
their primary rays fall through the Möller–Trumbore test on a quad's
diagonal, in the JAX package's op-by-op run (``jax.disable_jit``) too;
its jitted run's fused multiply-adds close the crack.

A 64×36 court frame (2 spp, max path length 3), path-traced and ReSTIR,
against the JAX package on the CPU. The court is the first scene with
alpha-tested triangles: its grates take the alpha loop
(``trace_nearest``) and ReSTIR's visibility its alpha-only trace. The
JAX package's jitted run differs from its own op-by-op run on 1.5% of
the pixels (ldr 98.481% within 1e-3, mean |Δ| 3.10e-4 on PT, 2.32e-4 on
ReSTIR; hdr 98.481%, 1.13e-3: the jitted primary trace), and the port
reads the same against the jitted run. Against the op-by-op run, which
fuses no multiply-adds either, the port reads 100% and ≤ 6.3e-8, held to
tests/test_torch_slice.py's tolerance (≥ 99.5%, < 1e-4); against the
jitted run to the JAX package's own spread (≥ 98%, 1.25× its mean).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.models import procedural as j_proc
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.render.restir import ReSTIRConfig as JReSTIRConfig
from merian_quake_tpu.renderer import render_sequence as j_render_sequence
from merian_quake_tpu_torch.accel.build import scene_features
from merian_quake_tpu_torch.models import procedural
from merian_quake_tpu_torch.models.types import RenderConfig, Scene, Uniforms
from merian_quake_tpu_torch.render.restir import ReSTIRConfig
from merian_quake_tpu_torch.renderer import render_sequence

torch.set_num_threads(min(2, torch.get_num_threads()))

SCENES = {
    "court": {}, "court_fog": {"fog_mu_t": 0.002}, "alcove": {}, "furnace": {},
    "furnace_bright": {"albedo": 0.8, "emission": 2.0},
}


def _name(key):
    return key.split("_")[0]


@pytest.mark.parametrize("key", list(SCENES))
def test_scene_arrays_equal_reference(key):
    kw = SCENES[key]
    jb = j_proc.get_scene(_name(key), **kw)
    tb = procedural.get_scene(_name(key), device="cpu", **kw)
    for f in Scene._fields:
        want, got = np.asarray(getattr(jb.scene, f)), getattr(tb.scene, f).numpy()
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(tb.atlas.table.numpy(), np.asarray(jb.atlas.table))
    assert len(tb.atlas.mips) == len(jb.atlas.mips)
    texels = lambda a: [a.data, a.flat, *a.mips]
    for a, b in zip(texels(tb.atlas), texels(jb.atlas)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2.5e-7, atol=0)
    for f in Uniforms._fields:
        want, got = np.asarray(getattr(jb.uniforms, f)), getattr(tb.uniforms, f)
        got = np.asarray(got) if isinstance(got, int) else got.numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=f)
    if key == "court_fog":
        assert float(tb.uniforms.mu_t) == np.float32(0.002)
        np.testing.assert_array_equal(tb.uniforms.mu_s.numpy(), np.float32(0.002 * 0.7))
    feats = scene_features(tb.scene, tb.uniforms, tb.atlas)
    assert feats.has_alpha_tris == (_name(key) == "court")  # the grates


@pytest.mark.parametrize("tex, args", [
    ("_grate_tex", ()), ("_sky_tex", (64, 3)), ("_sky_tex", (64, 9)),
    ("_checker_tex", ((170, 160, 150), (120, 110, 100))), ("_const_tex", ((255, 240, 160),)),
])
def test_texture_bytes_equal_reference(tex, args):
    want = getattr(j_proc, tex)(*args)
    got = getattr(procedural, tex)(*args)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if tex == "_grate_tex":
        assert 0 < (got[..., 3] == 0).mean() < 1  # holes and bars


def _furnace(w, h, spp, frames):
    cfg = RenderConfig(width=w, height=h, spp=spp, max_path_length=3, seed=1337)
    return render_sequence(procedural.get_scene("furnace", device="cpu"), cfg, frames=frames,
                           device="cpu")


def test_furnace_energy():
    """Pixel irradiance in the furnace = E × ∫ bsdf·cos dω, just below 1
    for roughness 0.6 (tests/test_render_e2e.py:26)."""
    state, _ = _furnace(64, 36, spp=8, frames=4)
    irr = state.accum_irradiance[..., :3].numpy()
    assert 0.93 < irr.mean() < 1.02, irr.mean()
    # uniform environment → low spatial variance after averaging
    assert irr.std() < 0.25


def test_furnace_direct_and_albedo():
    state, _ = _furnace(32, 18, spp=1, frames=1)
    direct = state.accum_direct[..., :3].numpy()
    lit = np.abs(direct - 1.0).max(-1) <= 1e-3  # every pixel sees E=1 ...
    assert (~lit).sum() <= 2 and (direct[~lit] == 0.0).all()  # ... but the cracks
    # albedo demodulation: emissive first hits have zero gbuffer albedo
    np.testing.assert_allclose(state.accum_albedo[..., :3].numpy(), 0.0, atol=1e-5)


def _agree(ours, ref, share=0.995, mean=1e-4):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    d = np.abs(ours - ref)
    assert (d.max(-1) <= 1e-3).mean() >= share, (d.max(-1) <= 1e-3).mean()
    assert d.mean() < mean, d.mean()


# against the jitted run: the JAX package's own spread, per output
JIT_BOUND = {"ldr": (0.98, 3.9e-4), "hdr": (0.98, 1.42e-3)}


@pytest.mark.parametrize("integrator", ["pt", "restir"])
def test_court_frame_matches_jax(integrator):
    kw = dict(width=64, height=36, spp=2, max_path_length=3, integrator=integrator)
    j_cfg = JReSTIRConfig() if integrator == "restir" else None
    run = lambda: j_render_sequence(j_proc.outdoor_court(), JConfig(**kw), frames=1,
                                    mcpg_config=j_cfg)[1]
    j_out = run()
    jax.block_until_ready(j_out["ldr"])
    with jax.disable_jit():
        k_out = run()
    t_cfg = ReSTIRConfig() if integrator == "restir" else None
    state, out = render_sequence(procedural.outdoor_court(device="cpu"), RenderConfig(**kw), frames=1,
                                 mcpg_config=t_cfg, device="cpu")
    for key in ("ldr", "hdr"):
        _agree(out[key], k_out[key])
        _agree(out[key], j_out[key], *JIT_BOUND[key])
    assert float(out["ldr"].std()) > 0.01
    assert state.iteration == 1
    assert jnp.isfinite(j_out["hdr"]).all()
