"""Slice 11 end to end: the denoised path-traced frame (SVGF, exposure,
tonemap, TAA, FXAA), port against JAX package, on cornell_box at 64×36,
2 spp, max path length 3, ``denoise=True``, 3 frames (the cases live in
tests/torch_denoise_cases.py; SSMM's denoised frames are in
test_torch_ssmm_slice.py, the fogged court's two SVGFs in
test_torch_denoise_volume.py).

Two comparisons:

1. The sequence. The port's 3 frames from an empty state against the
   JAX package's jitted ones, with bounds read from the JAX package's
   own spread between its jitted and its op-by-op run of the same frames
   (``scripts/denoise_spread.py pt``). On the box that spread is wide:
   its walls are flat and lit alike, so the variance that the à-trous
   luminance weight divides by is ~0 there, and the ulps that XLA's
   contracted multiply-adds leave in a luminance move weights by O(1).
   Read, share within 1e-3 and mean |Δ|: ldr 13.8% / 7.57e-3, hdr 70.6%
   / 3.16e-3, svgf.irr 99.7% / 4.32e-3. The port reads the same against
   the jitted run, and against the op-by-op run ldr 99.96% / 1.7e-6, hdr
   100% / 7.1e-9. Bounds: share at least the JAX package's less 0.02,
   mean at most 1.25× its mean.
2. One frame on carried state. Frame 2 from the JAX package's jitted
   state after frames 0-1, carried across by ``interop``, against the
   JAX package's op-by-op frame 2 from the same state (neither side
   contracts a multiply-add): hdr and svgf.irr within 1e-3 on ≥ 99.9% of
   pixels, mean |Δ| < 1e-5; ldr and taa_prev on ≥ 99.5%, mean < 2e-5
   (FXAA's and the TAA clamp's decisions may flip on an ulp). Against
   the jitted frame 2 it is held to that frame's own spread, measured in
   the test.

Mutants: TAA's history taken after FXAA fails the one-frame bound
(taa_prev); the à-trous step not doubling fails both.
"""
import pytest
import torch

from torch_denoise_cases import (
    FRAMES, H, W, Case, install_mutant, one_frame_agrees, sequence_agrees,
)

torch.set_num_threads(min(2, torch.get_num_threads()))

# scripts/denoise_spread.py pt: the JAX package's jitted-vs-op-by-op
# spread over the 3 frames, (share within 1e-3, mean |d|)
SPREAD = {"ldr": (0.13845, 7.573e-3), "hdr": (0.70573, 3.162e-3), "svgf.irr": (0.99696, 4.320e-3)}
ONE_FRAME = {"hdr": (0.999, 1e-5), "svgf.irr": (0.999, 1e-5), "ldr": (0.995, 2e-5),
             "taa_prev": (0.995, 2e-5)}


@pytest.fixture(scope="module")
def case():
    return Case("pt", one_frame_keys=tuple(ONE_FRAME))


def test_denoised_sequence_matches_jax(case):
    t_state, t_out = run = case.sequence()
    sequence_agrees(case, run, SPREAD)
    assert t_out["ldr"].shape == (H, W, 3) and float(t_out["ldr"].std()) > 0.01
    # the plain accumulators keep their inputs; the denoiser's histories move
    assert not t_state.accum_irradiance.any() and not t_state.accum_albedo.any()
    assert float(t_state.svgf.history_len.max()) == FRAMES and t_state.taa_prev.shape == (H, W, 3)
    assert t_state.volume_svgf is None and t_state.ssmm is None


def test_denoised_frame_on_carried_state_matches_jax(case):
    one_frame_agrees(case, case.one_frame(), ONE_FRAME)


@pytest.mark.parametrize("name", ["taa history after fxaa", "atrous step not doubling"])
def test_mutant_fails_the_bound(case, monkeypatch, name):
    install_mutant(name, monkeypatch)
    with pytest.raises(AssertionError):
        one_frame_agrees(case, case.one_frame(), ONE_FRAME)
    if name == "atrous step not doubling":
        with pytest.raises(AssertionError):
            sequence_agrees(case, case.sequence(), SPREAD)
