"""Certification of config5 (utils/certify.py): the twin of
tests/test_certify.py's fogged-court case on the port, and its numbers and
images against the JAX package's at the same arguments, on the CPU.

config5 (MCPG + the volume pass on ``outdoor_court(0.002)``) at
``scale=0.05`` (96×48), 16 frames, 32 truth frames in 2 runs; the truth
is the unguided MCPG with the volume (``_unguided_config``). The JAX
package's criteria: the volume is certified, and ``ratio_vs_pt`` and
``ratio_trimmed_vs_pt`` are below 1.15.

The JAX package's values (``scripts/certify_jax_values.py config5``; its
run takes minutes, so the constants below and
tests/data/certify_config5_jax.npz are its readings). The witness is its
op-by-op run: like the port's eager ops it contracts no multiply-add,
where the jitted run does, and the port's images part from it on 2.4-3.6%
of their pixels against the jitted run's 7.4-9.2%. Where an ulp decides a
path the runs part, so each bound is 1.25× the JAX package's own
jitted-vs-op-by-op spread:

- the relMSE, the equal-budget relMSE and the two trimmed relMSEs within
  1.25× their own spread (0.72%, 0.80%, 0.96%, 1.09%); the port reads
  0.27%, 0.02%, 0.35%, 0.04%;
- each ratio within 1.25× the sum of its two relMSEs' spreads (1.90%,
  2.56%); the port reads 0.24% and 0.32%. The ratios' own spreads (0.085%,
  0.12%) are not their yardstick: between the JAX package's two runs the
  truth's pixels part, which moves both relMSEs alike and leaves their
  ratio, while the port's candidate parts from the witness on more pixels
  than its truth does;
- each of the four images certify renders (the two truth runs, the
  candidate, the equal-budget reference) has no more pixels whose largest
  channel is 1e-3 or more (relative) from the witness's than 1.25× the
  share by which the JAX package's own two images part.

At the earlier budget of 6 frames and 48 truth frames a handful of
fireflies decided the relMSEs (the JAX package's spread 26%), so a 10%
error in the guided or volume path would have passed; here the spreads are
about 1%. The mutants (the truth without the volume; the candidate
unguided, ``surf_bsdf_p = 1``) are tests/test_torch_certify_court_mutant.py:
a file each keeps the suite's files short.
"""
import os

import numpy as np
import torch

from merian_quake_tpu_torch.utils import certify as t_certify

torch.set_num_threads(min(2, torch.get_num_threads()))

ARGS = dict(names=["config5"], scale=0.05, frames=16, ref_frames=32, ref_runs=2)
# scripts/certify_jax_values.py config5, the JAX package's op-by-op run
JAX_CONFIG5 = {"relmse": 0.5774738141777794, "relmse_pt_equal_budget": 0.5745826767255507,
               "ratio_vs_pt": 1.005031717051939, "relmse_trimmed": 0.4320106111910015,
               "relmse_trimmed_pt": 0.4263203751175927,
               "ratio_trimmed_vs_pt": 1.0133473237628843}
# the same script's jitted-vs-op-by-op spread, relative
SPREAD = {"relmse": 0.0071804528868116, "relmse_pt_equal_budget": 0.008039056128932943,
          "relmse_trimmed": 0.009637152689395547, "relmse_trimmed_pt": 0.010882369187667017}
BOUND = {k: 1.25 * v for k, v in SPREAD.items()}
BOUND["ratio_vs_pt"] = 1.25 * (SPREAD["relmse"] + SPREAD["relmse_pt_equal_budget"])
BOUND["ratio_trimmed_vs_pt"] = 1.25 * (SPREAD["relmse_trimmed"] + SPREAD["relmse_trimmed_pt"])

# the images: the op-by-op run's (the same script, --images tests/data)
# and the share of pixels by which its jitted run's part from them
IMAGES = os.path.join(os.path.dirname(__file__), "data", "certify_config5_jax.npz")
IMAGE_NAMES = ["truth_run_1", "truth_run_2", "candidate", "reference"]
PIX_REL = 1e-3
PIX_SPREAD = {"truth_run_1": 0.0859375, "truth_run_2": 0.09223090277777778,
              "candidate": 0.08832465277777778, "reference": 0.07356770833333333}


def pixels_apart(a, b, rel=PIX_REL) -> float:
    """Share of pixels whose largest channel differs by more than ``rel``
    relative to ``b`` (1e-3 absolute near black), as the script reads it."""
    d = np.abs(np.asarray(a, np.float64) - b) / (np.abs(np.asarray(b, np.float64)) + 1e-3)
    return float((d.max(-1) > rel).mean())


def config5():
    """certify_presets' row for config5 and the images its ``_run`` calls
    returned, by name."""
    plain, images = t_certify._run, []

    def spy(*a, **k):
        out = plain(*a, **k)
        images.append(out)
        return out

    t_certify._run = spy
    try:
        r = t_certify.certify_presets(device="cpu", **ARGS)["config5"]
    finally:
        t_certify._run = plain
    return r, dict(zip(IMAGE_NAMES, images, strict=True))


def agrees(r):
    for key, want in JAX_CONFIG5.items():
        rel = abs(r[key] - want) / want
        assert rel <= BOUND[key], (key, r[key], want, rel, BOUND[key])


def images_agree(images):
    want = np.load(IMAGES)
    for name, img in images.items():
        apart = pixels_apart(img, want[name])
        assert apart <= 1.25 * PIX_SPREAD[name], (name, apart, 1.25 * PIX_SPREAD[name])


def test_certify_mcpg_court_within_factor():
    """config5's integrator (MCPG + volume, certified fog-aware) at equal
    budget stays within a small factor of unguided transport, and gives
    the JAX package's numbers and images within its own spread."""
    r, images = config5()
    assert np.isfinite(r["relmse"]) and r["resolution"] == "96x48"
    assert r["volume_included"] is True
    assert r["ratio_vs_pt"] < 1.15, r
    assert r["ratio_trimmed_vs_pt"] < 1.15, r
    agrees(r)
    images_agree(images)
