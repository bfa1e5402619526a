"""The port's ops library against the JAX package's, on the same inputs.

Integer hashing (rng, octahedral encoding) must match bit for bit: any
drift there changes every random stream. Float ops are held to
rtol 1e-6: XLA on the CPU contracts a*b+c into fused multiply-adds and
PyTorch does not, so results differ by a few ulps. The atol of 1e-6
covers components that cancel to ~0 (unit-vector components, dot
products), where a few ulps of the inputs are no longer relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.ops import bsdf as j_bsdf
from merian_quake_tpu.ops import camera as j_camera
from merian_quake_tpu.ops import color as j_color
from merian_quake_tpu.ops import linalg as j_linalg
from merian_quake_tpu.ops import octahedral as j_oct
from merian_quake_tpu.ops import rng as j_rng
from merian_quake_tpu.ops import transmittance as j_trans
from merian_quake_tpu.ops import vmf as j_vmf
from merian_quake_tpu_torch.ops import bsdf, camera, color, linalg, octahedral
from merian_quake_tpu_torch.ops import rng as t_rng
from merian_quake_tpu_torch.interop import tensor
from merian_quake_tpu_torch.ops import transmittance, vmf


def _t(x):
    """An array as a CPU tensor (the interop default is the card)."""
    return tensor(x, device="cpu")


# The suite runs several test processes side by side on a few cores;
# torch would start one thread per core in each and oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

RTOL, ATOL = 1e-6, 1e-6


def _u32(x):
    return np.asarray(x).astype(np.uint32)


def _units(gen, n):
    v = gen.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _close(ours, ref):
    np.testing.assert_allclose(
        np.asarray(ours), np.asarray(ref), rtol=RTOL, atol=ATOL
    )


# ---------------------------------------------------------------- rng


def test_pcg4d_bit_exact(rng):
    v = rng.integers(0, 2**32, size=(4096, 4), dtype=np.uint64)
    v[:8] = 2**32 - 1 - np.arange(8)[:, None]  # top of the range
    ref = j_rng.pcg4d(jnp.asarray(v.astype(np.uint32)))
    ours = t_rng.pcg4d(_t(v.astype(np.int64)))
    np.testing.assert_array_equal(_u32(ours), np.asarray(ref))
    assert (np.asarray(ref) >= 2**31).any() and ours.dtype == torch.int64


@pytest.mark.parametrize("frame,seed", [(0, 1337), (7, 0), (2**31 + 5, 2**32 - 3)])
def test_seed_pixel_bit_exact(frame, seed):
    py, px = np.meshgrid(np.arange(37), np.arange(53), indexing="ij")
    px, py = px.reshape(-1).astype(np.int32), py.reshape(-1).astype(np.int32)
    ref = j_rng.seed_pixel(
        jnp.asarray(px), jnp.asarray(py), jnp.uint32(frame), jnp.uint32(seed)
    )
    ours = t_rng.seed_pixel(_t(px), _t(py), frame, seed)
    np.testing.assert_array_equal(_u32(ours), np.asarray(ref))


def test_xorshift_and_uniforms_bit_exact(rng):
    s = rng.integers(1, 2**32, size=(8192,), dtype=np.uint64)
    s[:4] = [1, 2**31, 2**31 + 1, 2**32 - 1]
    js = jnp.asarray(s.astype(np.uint32))
    ts = _t(s.astype(np.int64))
    np.testing.assert_array_equal(_u32(t_rng.xorshift32_raw(ts)), np.asarray(j_rng.xorshift32_raw(js)))
    for _ in range(3):
        js, ju = j_rng.uniform3(js)
        ts, tu = t_rng.uniform3(ts)
        np.testing.assert_array_equal(_u32(ts), np.asarray(js))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    js, ju = j_rng.uniform4(js)
    ts, tu = t_rng.uniform4(ts)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


# ---------------------------------------------------------------- octahedral


def test_octahedral_encode_decode_bit_exact(rng):
    n = _units(rng, 4096)
    n[:6] = np.eye(3, dtype=np.float32).repeat(2, 0) * np.array([1, -1] * 3, np.float32)[:, None]
    enc = j_oct.encode_normal(jnp.asarray(n))
    ours = octahedral.encode_normal(_t(n))
    np.testing.assert_array_equal(_u32(ours), np.asarray(enc))
    dec = j_oct.decode_normal(enc)
    np.testing.assert_array_equal(
        octahedral.decode_normal(ours).numpy(), np.asarray(dec)
    )


# ---------------------------------------------------------------- float ops


def test_linalg_frames(rng):
    n = _units(rng, 2048)
    v = rng.normal(size=(2048, 3)).astype(np.float32)
    u = rng.uniform(size=(2048, 2)).astype(np.float32)
    for a, b in zip(j_linalg.make_frame(jnp.asarray(n)), linalg.make_frame(_t(n))):
        _close(b, a)
    _close(linalg.world_to_frame(_t(n), _t(v)), j_linalg.world_to_frame(jnp.asarray(n), jnp.asarray(v)))
    _close(linalg.sample_cos(_t(n), _t(u)), j_linalg.sample_cos(jnp.asarray(n), jnp.asarray(u)))
    _close(linalg.cos_pdf(_t(n), _t(v)), j_linalg.cos_pdf(jnp.asarray(n), jnp.asarray(v)))
    _close(linalg.normalize(_t(v)), j_linalg.normalize(jnp.asarray(v)))


def test_bsdf_sample_pdf_eval(rng):
    n = _units(rng, 4096)
    wi = _units(rng, 4096)
    wi[:1024] = -np.abs(wi[:1024]) * np.sign(n[:1024])  # half-ish front-facing
    rough = rng.uniform(0.05, 1.0, size=(4096,)).astype(np.float32)
    u3 = rng.uniform(size=(4096, 3)).astype(np.float32)
    ja = j_bsdf.roughness_to_alpha(jnp.asarray(rough))
    ta = bsdf.roughness_to_alpha(_t(rough))
    _close(ta, ja)
    jwo = j_bsdf.sample(jnp.asarray(wi), jnp.asarray(n), ja, jnp.asarray(u3))
    two = bsdf.sample(_t(wi), _t(n), ta, _t(u3))
    _close(two, jwo)
    wo = np.asarray(jwo)  # same direction into pdf/eval on both sides
    _close(
        bsdf.pdf(_t(wi), _t(wo), _t(n), ta),
        j_bsdf.pdf(jnp.asarray(wi), jnp.asarray(wo), jnp.asarray(n), ja),
    )
    _close(
        bsdf.eval_times_cos(_t(wi), _t(wo), _t(n), ta),
        j_bsdf.eval_times_cos(jnp.asarray(wi), jnp.asarray(wo), jnp.asarray(n), ja),
    )


@pytest.mark.parametrize("kappa", [0.0, 0.5, 30.0, 3000.0])
def test_vmf_sample_pdf(rng, kappa):
    mu = _units(rng, 2048)
    w = _units(rng, 2048)
    u = rng.uniform(size=(2048, 2)).astype(np.float32)
    _close(vmf.pdf(_t(w), _t(mu), kappa), j_vmf.pdf(jnp.asarray(w), jnp.asarray(mu), kappa))
    r = u[:, 0] * 0.999
    _close(vmf.kappa_from_mean_cos(_t(r)), j_vmf.kappa_from_mean_cos(jnp.asarray(r)))
    # cos θ = 1 + log(·)/κ divides the log's last-ulp difference by κ, and
    # sin θ = sqrt(1 - cos² θ) magnifies it again near the poles: the
    # sampled components get atol 5e-6 (measured worst 1.8e-6 at κ = 0.5)
    np.testing.assert_allclose(
        vmf.sample(_t(mu), kappa, _t(u)).numpy(),
        np.asarray(j_vmf.sample(jnp.asarray(mu), kappa, jnp.asarray(u))),
        rtol=RTOL, atol=5e-6,
    )


def test_camera_ray_dir_and_project(rng):
    W, H = 64, 36
    px = rng.integers(0, W, size=512).astype(np.float32)
    py = rng.integers(0, H, size=512).astype(np.float32)
    cu = np.asarray([0.0, 0.0, 1.0], np.float32)
    cw = np.asarray([0.7, 0.7, -0.1], np.float32)
    fov = np.float32(np.tan(np.deg2rad(90.0) / 2))
    jd = j_camera.ray_dir(jnp.asarray(px), jnp.asarray(py), W, H, jnp.asarray(cu), jnp.asarray(cw), fov)
    td = camera.ray_dir(_t(px), _t(py), W, H, _t(cu), _t(cw), _t(fov))
    _close(td, jd)
    jp = j_camera.project(jd, W, H, jnp.asarray(cu), jnp.asarray(cw), fov)
    tp = camera.project(_t(np.asarray(jd)), W, H, _t(cu), _t(cw), _t(fov))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(b, a.numpy(), rtol=RTOL, atol=1e-4)  # pixel units


def test_color_and_transmittance(rng):
    c = rng.uniform(-0.1, 3.0, size=(4096, 3)).astype(np.float32)
    for jf, tf in (
        (j_color.yuv_luminance, color.yuv_luminance),
        (j_color.srgb_to_linear, color.srgb_to_linear),
        (j_color.linear_to_srgb, color.linear_to_srgb),
    ):
        _close(tf(_t(c)), jf(jnp.asarray(c)))
    # ldr_to_hdr multiplies by l / (1 - l) with l = mean^0.1 up to 0.99:
    # the pow's last-ulp difference grows up to 100x (measured 5.1e-6)
    np.testing.assert_allclose(
        color.ldr_to_hdr(_t(c)).numpy(), np.asarray(j_color.ldr_to_hdr(jnp.asarray(c))),
        rtol=2e-5, atol=ATOL,
    )
    t = rng.uniform(0, 3000, size=4096).astype(np.float32)
    xi = rng.uniform(size=4096).astype(np.float32)
    for mu_t in (0.0, 1e-3, 0.02):
        _close(transmittance.transmittance(_t(t), mu_t, 1000.0),
               j_trans.transmittance(jnp.asarray(t), mu_t, 1000.0))
        _close(transmittance.sample(_t(xi), mu_t, 1000.0), j_trans.sample(jnp.asarray(xi), mu_t, 1000.0))
        _close(transmittance.pdf(_t(t), mu_t, 1000.0), j_trans.pdf(jnp.asarray(t), mu_t, 1000.0))
