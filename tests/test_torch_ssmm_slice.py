"""Slice 11 end to end: the denoised SSMM frame, port against JAX
package, on cornell_box at 64×36, 2 spp, ``denoise=True``, 3 frames
(the case lives in tests/torch_denoise_cases.py; the comparisons are
those of test_torch_denoise_slice.py).

1. The sequence against the JAX package's jitted frames, bounds from its
   own jitted-vs-op-by-op spread (``scripts/denoise_spread.py ssmm``).
   SSMM's chains turn on float comparisons (the Metropolis test, the
   candidate pick), so an ulp moves a chain and the image follows; the
   denoiser then spreads a moved pixel over its footprint. Read, share
   within 1e-3 and mean |Δ|: ldr 35.3% / 7.37e-3, hdr 37.5% / 4.05e-3,
   svgf.irr 93.3% / 2.93e-2, the raw irradiance 93.6% / 9.74e-2. The
   port reads the same against the jitted run (to 0.05 point), and
   against the op-by-op run ldr 99.96% / 1.7e-6, hdr 100% / 5.3e-9,
   irradiance 100% / 1.9e-8. Bounds: share at least the JAX package's
   less 0.02, mean at most 1.25× its mean.
2. Frame 2 on the JAX package's carried state against its op-by-op
   frame 2: hdr, svgf.irr and the chains' irradiance on ≥ 99.9%, mean <
   1e-5; ldr and taa_prev on ≥ 99.5%, mean < 2e-5; against its jitted
   frame 2 within that frame's own spread.

Mutant: the lane shuffle rolled the other way fails the one-frame bound.
"""
import pytest
import torch

from torch_denoise_cases import Case, install_mutant, one_frame_agrees, sequence_agrees

torch.set_num_threads(min(2, torch.get_num_threads()))

SPREAD = {"ldr": (0.35286, 7.372e-3), "hdr": (0.37457, 4.050e-3), "svgf.irr": (0.93273, 2.926e-2),
          "irradiance": (0.93620, 9.740e-2)}
ONE_FRAME = {"hdr": (0.999, 1e-5), "svgf.irr": (0.999, 1e-5), "irradiance": (0.999, 1e-5),
             "ldr": (0.995, 2e-5), "taa_prev": (0.995, 2e-5)}


@pytest.fixture(scope="module")
def case():
    return Case("ssmm", one_frame_keys=tuple(ONE_FRAME))


def test_denoised_ssmm_sequence_matches_jax(case):
    t_state, t_out = run = case.sequence()
    sequence_agrees(case, run, SPREAD)
    assert float(t_out["ldr"].std()) > 0.01 and float(t_state.ssmm.sum_w.max()) > 0.0
    assert t_state.ssmm.N.dtype == torch.int32 and t_state.ssmm.N.shape == (64 * 36,)


def test_denoised_ssmm_frame_on_carried_state_matches_jax(case):
    one_frame_agrees(case, case.one_frame(), ONE_FRAME)


def test_mutant_fails_the_bound(case, monkeypatch):
    install_mutant("roll flipped", monkeypatch)
    with pytest.raises(AssertionError):
        one_frame_agrees(case, case.one_frame(), ONE_FRAME)
