"""ops/phase.py and the volume's use of ops/transmittance.py: port
against JAX package, same numpy inputs.

The Draine inverse-CDF table is built on the host in float64 by the same
numpy code: equal bit for bit. The pdfs, the table lookup and the
direction frame are f32 arithmetic on both sides: within f32 rounding
(read: ≤ 2 ulps; bounds rtol 1e-6 on values, atol 1e-6 on unit
vectors). ``xi_max`` is called as the volume pass calls it, with the
uniforms' 0-d ``mu_t`` and a per-pixel truncation distance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.ops import phase as j_phase
from merian_quake_tpu.ops import transmittance as j_trans
from merian_quake_tpu.render.mcpg.volume import VolumeConfig as JVolumeConfig
from merian_quake_tpu_torch.ops import phase, transmittance
from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig

torch.set_num_threads(min(2, torch.get_num_threads()))

SIZES = [7.0, 25.0, 1.5, 60.0]  # µm: production, the default, strong and weak anisotropy


def _ga(size):
    v, jv = VolumeConfig(particle_size_um=size), JVolumeConfig(particle_size_um=size)
    assert (v.draine_g, v.draine_a) == (jv.draine_g, jv.draine_a)
    return v.draine_g, v.draine_a


@pytest.mark.parametrize("size", SIZES)
def test_draine_table_bit_exact(size):
    g, a = _ga(size)
    want = np.asarray(j_phase.draine_inverse_cdf_table(g, a))
    got = phase.draine_inverse_cdf_table(g, a)
    assert got.dtype == np.float32 and got.shape == (phase.DRAINE_TABLE_SIZE,)
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got) >= 0).all() and -1.0 <= got[0] and got[-1] <= 1.0
    np.testing.assert_array_equal(phase._device_table(g, a, "cpu").numpy(), want)


@pytest.mark.parametrize("size", SIZES)
def test_draine_pdf_and_sampling_match(size):
    g, a = _ga(size)
    r = np.random.default_rng(int(size * 10))
    cos = np.concatenate([r.uniform(-1, 1, 4096), [-1.0, 0.0, 1.0]]).astype(np.float32)
    np.testing.assert_allclose(
        phase.draine_pdf(torch.from_numpy(cos), g, a).numpy(),
        np.asarray(j_phase.draine_pdf(jnp.asarray(cos), g, a)), rtol=1e-6)
    np.testing.assert_allclose(
        phase.hg_pdf(torch.from_numpy(cos), g).numpy(),
        np.asarray(j_phase.hg_pdf(jnp.asarray(cos), g)), rtol=1e-6)
    u = np.concatenate([r.uniform(0, 1, 4096), [0.0, 0.5, 0.99999994]]).astype(np.float32)
    hits = phase._device_table.cache_info().hits
    got = phase.draine_sample_cos(torch.from_numpy(u), g, a)
    phase.draine_sample_cos(torch.from_numpy(u), g, a)
    assert phase._device_table.cache_info().hits >= hits + 1  # built once, then kept
    want = np.asarray(j_phase.draine_sample_cos(jnp.asarray(u), g, a))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # the sampled cosines follow the pdf: mean cos = g_eff > 0 (forward)
    assert got.abs().max() <= 1.0 and float(got.mean()) > 0.0


def test_sample_dir_matches():
    r = np.random.default_rng(3)
    w = r.normal(size=(4096, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    w[:3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]  # the frame's branch points
    cos = r.uniform(-1, 1, 4096).astype(np.float32)
    u = r.uniform(0, 1, 4096).astype(np.float32)
    got = phase.sample_dir(torch.from_numpy(w), torch.from_numpy(cos), torch.from_numpy(u)).numpy()
    want = np.asarray(j_phase.sample_dir(jnp.asarray(w), jnp.asarray(cos), jnp.asarray(u)))
    # the same frame in float64 (Duff et al.'s basis), for both packages
    w64, c64, phi = w.astype(np.float64), cos.astype(np.float64), 2.0 * np.pi * u.astype(np.float64)
    sign = np.where(w64[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + w64[:, 2])
    b_ = w64[:, 0] * w64[:, 1] * a
    t = np.stack([1.0 + sign * w64[:, 0] ** 2 * a, sign * b_, -sign * w64[:, 0]], -1)
    b = np.stack([b_, sign + w64[:, 1] ** 2 * a, -w64[:, 1]], -1)
    s = np.sqrt(np.maximum(1.0 - c64 * c64, 0.0))
    model = (t * (s * np.cos(phi))[:, None] + b * (s * np.sin(phi))[:, None] + w64 * c64[:, None])
    np.testing.assert_allclose(got, model, atol=2e-6)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose((got * w).sum(-1), cos, atol=1e-5)


@pytest.mark.parametrize("mu_t", [0.0, 0.002, 0.004, 1.0])
def test_xi_max_with_0d_mu_t_and_pixel_max_t(mu_t):
    """As the volume pass calls it: ``uniforms.mu_t`` (0-d f32) against
    min(linear_z, volume_max_t) per pixel, sky pixels at 1000."""
    r = np.random.default_rng(5)
    max_t = np.minimum(r.uniform(0.0, 3000.0, 2304), 1000.0).astype(np.float32)
    max_t[:2] = [0.0, 1e-3]
    mu = torch.tensor(mu_t, dtype=torch.float32)
    got = transmittance.xi_max(mu, torch.from_numpy(max_t))
    want = np.asarray(j_trans.xi_max(jnp.float32(mu_t), jnp.asarray(max_t)))
    assert got.dtype == torch.float32 and got.shape == max_t.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert (got.numpy() == 0).all() if mu_t == 0.0 else (got[2:] > 0).all()
