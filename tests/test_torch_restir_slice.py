"""Slice 2 end to end: the ReSTIR DI frame, port against JAX package.

``render_sequence`` on city at 48×27, ``integrator="restir"``,
``ReSTIRConfig()`` defaults, 3 frames, the same seed, on the CPU (both
sides trace with the Möller–Trumbore oracle). XLA fuses multiply-adds on
the CPU and PyTorch does not; one ulp in a reservoir's weight can flip a
selection and send that pixel's sample elsewhere, and the flip is carried
into the next frames' reuse. So images and weights are held by the share
of pixels that agree and by the mean difference. Every bound is set from
the JAX package's own reading of its jitted run against an op-by-op run
(``jax.disable_jit``) on the same pixels: its share less about 2 pixels
of 1,296 (a point of share on the sky and emissive pixels), and 1.25×
its mean. Readings (JAX jit vs op-by-op → port vs jit):

- ldr 99.846% within 1e-3, mean |Δ| 1.76e-5 → 99.846%, 1.88e-5;
- hdr 99.846%, 1.70e-5 → 99.846%, 1.43e-5;
- accum_irradiance on the pixels the image uses (accum_albedo > 0):
  99.739%, 1.14e-4 → 99.739%, 9.6e-5; on the others (sky, emissive;
  never multiplied into the image) 96.604%, 9.31e-4 → 96.604%, 1.04e-3;
- accum_direct and accum_albedo: 100%, ≤ 2.3e-8 on both;
- the reservoirs: M equal everywhere on both (largest M 8); W within
  rtol 1e-4 on 98.534% → 98.534%.

Bounds: ldr and hdr ≥ 99.6%, < 2.2e-5; used irradiance ≥ 99.5%,
< 1.45e-4; the other pixels ≥ 95.5%, < 1.17e-3; direct and albedo
≥ 99.9%, < 1e-6; M equal; W ≥ 98.3%.
"""
import jax
import numpy as np
import pytest
import torch

from merian_quake_tpu.models.procedural import city as j_city
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.render.restir import ReSTIRConfig as JReSTIRConfig
from merian_quake_tpu.renderer import render_sequence as j_render_sequence
from merian_quake_tpu_torch.models.procedural import city
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.render.restir import ReSTIRConfig
from merian_quake_tpu_torch.renderer import render_sequence

# The suite runs several test processes side by side on a few cores;
# torch would start one thread per core in each and oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

W, H, FRAMES = 48, 27, 3


@pytest.fixture(scope="module")
def frames():
    j_state, j_out = j_render_sequence(
        j_city(), JConfig(width=W, height=H, integrator="restir"), frames=FRAMES,
        mcpg_config=JReSTIRConfig(),
    )
    jax.block_until_ready(j_out["ldr"])
    t_state, t_out = render_sequence(
        city(device="cpu"), RenderConfig(width=W, height=H, integrator="restir"), frames=FRAMES,
        mcpg_config=ReSTIRConfig(), device="cpu",
    )
    return j_state, j_out, t_state, t_out


def _agree(ours, ref, share, mean, pixels=None):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    d = np.abs(ours - ref)
    per_pixel = d.max(-1) if d.ndim == 3 else d
    if pixels is not None:
        d, per_pixel = d[pixels], per_pixel[pixels]
    assert (per_pixel <= 1e-3).mean() >= share, (per_pixel <= 1e-3).mean()
    assert d.mean() < mean, d.mean()


@pytest.mark.parametrize("key", ["ldr", "hdr"])
def test_restir_outputs_match_jax(frames, key):
    _, j_out, _, t_out = frames
    _agree(t_out[key], j_out[key], 0.996, 2.2e-5)
    assert float(t_out["ldr"].std()) > 0.01


def test_restir_accumulated_state_matches_jax(frames):
    j_state, _, t_state, _ = frames
    assert t_state.iteration == int(j_state.iteration) == FRAMES
    used = np.asarray(j_state.accum_albedo)[..., :3].max(-1) > 0.0
    assert used.mean() > 0.5
    _agree(t_state.accum_irradiance, j_state.accum_irradiance, 0.995, 1.45e-4, used)
    _agree(t_state.accum_irradiance, j_state.accum_irradiance, 0.955, 1.17e-3, ~used)
    for f in ("accum_direct", "accum_albedo"):
        _agree(getattr(t_state, f), getattr(j_state, f), 0.999, 1e-6)


def test_restir_reservoirs_match_jax(frames):
    j_state, _, t_state, _ = frames
    res, j_res = t_state.restir.reservoirs, j_state.restir.reservoirs
    np.testing.assert_array_equal(res.M.numpy(), np.asarray(j_res.M))
    assert int(res.M.max()) == 8
    w, j_w = res.w.numpy(), np.asarray(j_res.w)
    assert np.isfinite(w).all()
    assert (np.abs(w - j_w) <= 1e-4 * np.maximum(np.abs(j_w), 1e-30)).mean() >= 0.983
