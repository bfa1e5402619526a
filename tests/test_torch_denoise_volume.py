"""Slice 11 end to end: the denoised MCPG frame with the volume pass and
its own SVGF, port against JAX package: the fogged court
(``outdoor_court(0.002)``) at 64×36, 1 spp, max path length 3,
``MCPGConfig(volume=VolumeConfig())``, ``denoise=True``, 3 frames (the
case lives in tests/torch_denoise_cases.py).

The port's 3 frames against the JAX package's jitted ones, with bounds
read from the JAX package's own jitted-vs-op-by-op spread
(``scripts/denoise_spread.py volume``). The volume's history is
reprojected along its motion vectors; under a still camera those are the
forward projection's rounding (±2e-5 pixels), so on the image border
whether a pixel keeps its history is an ulp's decision, in the volume's
accumulator and in both SVGF instances; the filters then spread each
such pixel over their footprints. Read, share within 1e-3 and mean |Δ|,
the JAX package against itself | the port against the jitted run:
ldr 44.7% / 2.15e-3 | 41.5% / 2.14e-3; hdr 27.6% / 5.57e-3 | 23.8% /
5.81e-3; the volume image 99.83% / 1.14e-4 | 99.78% / 8.9e-5; svgf.irr
98.39% / 9.07e-4 | 98.39% / 9.02e-4; volume_svgf.irr 97.31% / 4.46e-3 |
97.14% / 4.71e-3. Against the op-by-op run the port reads ldr 83.3% /
6.2e-4, svgf.irr 99.91% / 6.1e-6, volume_svgf.irr 99.31% / 1.19e-3: the
border's history decisions again. Bounds: share at least the JAX
package's less 0.05 (the port falls up to 3.8 points below it on the
denoised images, where the validity flips of three histories meet),
mean at most 1.25× its mean.

A mutant fails the bound: the volume's accumulated history added to the
image unfiltered (the second SVGF's output dropped).
"""
import pytest
import torch

from torch_denoise_cases import FRAMES, H, W, Case, install_mutant, sequence_agrees

torch.set_num_threads(min(2, torch.get_num_threads()))

SPREAD = {"ldr": (0.44748, 2.149e-3), "hdr": (0.27648, 5.573e-3), "volume": (0.99826, 1.139e-4),
          "svgf.irr": (0.98394, 9.069e-4), "volume_svgf.irr": (0.97309, 4.460e-3)}
MARGIN = 0.05


@pytest.fixture(scope="module")
def case():
    return Case("volume")


def test_denoised_volume_sequence_matches_jax(case):
    t_state, t_out = run = case.sequence()
    sequence_agrees(case, run, SPREAD, MARGIN)
    assert float(t_state.volume_svgf.history_len.max()) == FRAMES
    assert float(t_state.accum_volume[..., :3].mean()) > 0.05  # the fog scatters
    assert t_out["volume_mv"].shape == (H, W, 2) and not t_state.accum_irradiance.any()


def test_mutant_fails_the_bound(case, monkeypatch):
    install_mutant("volume history added unfiltered", monkeypatch)
    with pytest.raises(AssertionError):
        sequence_agrees(case, case.sequence(), SPREAD, MARGIN)
