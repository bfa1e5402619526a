"""The mutants of tests/test_torch_certify_court.py, each of which must
fail that file's bounds on the JAX package's numbers and images:

- config5's truth rendered without the volume term (the unguided
  reference's ``MCPGConfig.volume`` dropped, so the truth is the fogless
  surface);
- config5's candidate unguided on the surface (``surf_bsdf_p = 1``): the
  guided path's sampling changed, the volume's kept. At 16 frames guiding
  barely changes the court's noise (the ratio is about 1): the mutant's
  relMSE moves by 0.3% and its trimmed ratio by 0.4%, inside their bounds,
  so the images are what it has to fail (63% of the candidate's pixels
  apart against a bound of 11%); the same candidate rendered as the preset
  has it passes them.
"""
import pytest
import torch

from merian_quake_tpu_torch.accel.build import scene_features
from merian_quake_tpu_torch.presets import PRESETS
from merian_quake_tpu_torch.utils import certify as t_certify
from test_torch_certify_court import ARGS, agrees, config5, images_agree

torch.set_num_threads(min(2, torch.get_num_threads()))


def test_mutant_truth_without_the_volume_fails(monkeypatch):
    plain = t_certify._unguided_config

    def no_volume(cfg, integ):
        c, i = plain(cfg, integ)
        return (c, i) if i is None else (c._replace(integrator="pt"), None)

    monkeypatch.setattr(t_certify, "_unguided_config", no_volume)
    r, images = config5()
    assert r["volume_included"] is False
    with pytest.raises(AssertionError):
        agrees(r)
    with pytest.raises(AssertionError):
        images_agree({k: images[k] for k in ("truth_run_1", "truth_run_2", "reference")})


def test_mutant_unguided_candidate_fails():
    """The candidate as certify_presets renders it (96×48, no denoise, the
    scene's features), once as the preset has it and once with
    ``surf_bsdf_p = 1``."""
    p = PRESETS["config5"]
    bundle = p.make_bundle(device="cpu")
    cfg = p.config._replace(width=96, height=48, denoise=False,
                            features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas))
    run = lambda integ: t_certify._run(bundle, cfg, integ, ARGS["frames"], device="cpu")
    images_agree({"candidate": run(p.integ_config)})
    with pytest.raises(AssertionError):
        images_agree({"candidate": run(p.integ_config._replace(surf_bsdf_p=1.0))})
