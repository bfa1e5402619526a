"""Slice 1 end to end: the path-traced frame, port against JAX package.

``render_sequence`` on city at 48×27, 2 spp, max path length 3, 4 frames,
the same seed, on the CPU (both sides trace with the Möller–Trumbore
oracle). XLA fuses multiply-adds on the CPU and PyTorch does not; an
ulp of difference in one BSDF sample can send one path elsewhere, so
images are compared by the share of pixels that agree and the mean
error, not pixel by pixel:

- ldr, hdr, accum_direct, accum_albedo: ≥ 99.5% of pixels within 1e-3
  and mean |Δ| < 1e-4 (measured: 99.92% and 7.6e-6 for ldr);
- accum_irradiance, on the pixels whose irradiance the frame uses
  (accum_albedo > 0; hdr = irradiance × albedo + direct): the same
  bound (measured: 99.74% and 2.1e-5);
- accum_irradiance on the other pixels (sky, and emissive surfaces
  whose gbuffer albedo is zeroed but whose paths are still traced):
  raw path radiance and its second moment, never multiplied into the
  image and with no albedo or tonemap to damp a path that went
  elsewhere. On exactly these pixels the JAX package differs from
  itself between its jitted run and an op-by-op run (jax.disable_jit)
  of the same frames: 90.19% within 1e-3, mean |Δ| 3.22e-3. The port
  reads 90.38% and 3.48e-3 against the jitted run (the test's
  reference) and 98.68% and 4.8e-4 against the op-by-op one, which
  fuses no multiply-adds either. Bound: JAX's own reading less one
  point of share (≈5 of the 530 pixels), ≥ 89%, and 1.25× its mean,
  < 4e-3.
"""
import jax
import numpy as np
import pytest
import torch

from merian_quake_tpu.models.procedural import city as j_city
from merian_quake_tpu.models.types import RenderConfig as JConfig
from merian_quake_tpu.renderer import render_sequence as j_render_sequence
from merian_quake_tpu_torch.models.procedural import city, cornell_box
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.render.mcpg import MCPGConfig
from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig
from merian_quake_tpu_torch.renderer import init_state, render_sequence

# The suite runs several test processes side by side on a few cores;
# torch would start one thread per core in each and oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

W, H, SPP, MPL, FRAMES = 48, 27, 2, 3, 4


@pytest.fixture(scope="module")
def frames():
    j_state, j_out = j_render_sequence(
        j_city(), JConfig(width=W, height=H, spp=SPP, max_path_length=MPL), frames=FRAMES
    )
    jax.block_until_ready(j_out["ldr"])
    t_state, t_out = render_sequence(
        city(device="cpu"), RenderConfig(width=W, height=H, spp=SPP, max_path_length=MPL), frames=FRAMES,
        device="cpu",
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
def test_frame_outputs_match_jax(frames, key):
    j_state, j_out, t_state, t_out = frames
    _agree(t_out[key], j_out[key], 0.995, 1e-4)
    assert float(t_out["ldr"].std()) > 0.01


@pytest.mark.parametrize("field", ["accum_direct", "accum_albedo"])
def test_accumulated_state_matches_jax(frames, field):
    j_state, _, t_state, _ = frames
    _agree(getattr(t_state, field), getattr(j_state, field), 0.995, 1e-4)
    assert t_state.iteration == int(j_state.iteration) == FRAMES


def test_accumulated_irradiance_matches_jax(frames):
    j_state, _, t_state, _ = frames
    used = np.asarray(j_state.accum_albedo)[..., :3].max(-1) > 0.0
    assert used.mean() > 0.5
    _agree(t_state.accum_irradiance, j_state.accum_irradiance, 0.995, 1e-4, used)
    _agree(t_state.accum_irradiance, j_state.accum_irradiance, 0.89, 4e-3, ~used)


@pytest.mark.parametrize("config, integrator_config", [
    (RenderConfig(integrator="mcpg", denoise=True), MCPGConfig(volume=VolumeConfig())),
    (RenderConfig(integrator="ssmm"), None),
    (RenderConfig(denoise=True), None),
])
def test_unported_paths_raise(config, integrator_config):
    """The three configurations that raised NotImplementedError until the
    denoise chain and SSMM were ported (the test keeps its name) now
    build their state and render a 16×9 CPU frame."""
    config = config._replace(width=16, height=9)
    state = init_state(config, integrator_config, device="cpu")
    assert (state.svgf is not None) == config.denoise
    assert (state.volume_svgf is not None) == (integrator_config is not None)
    assert (state.ssmm is not None) == (config.integrator == "ssmm")
    state, out = render_sequence(cornell_box(device="cpu"), config, mcpg_config=integrator_config,
                                 device="cpu")
    assert out["ldr"].shape == (9, 16, 3) and bool(torch.isfinite(out["ldr"]).all())
    assert state.iteration == 1
