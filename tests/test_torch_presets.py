"""The presets (presets.py) and certification's reference configs
(utils/certify.py::_unguided_config): port against JAX package.

- Every preset has the JAX package's name, description, frame count,
  render config and integrator config, field for field, and the same
  scene (its triangles and uniforms equal); the three orbit presets keep
  the JAX package's orbit parameters (read from its closures) as data.
- ``_unguided_config`` gives the JAX package's reference config for each
  preset, field for field: PT, or for config5 (the volume) the unguided
  MCPG with ``surf_bsdf_p = 1``, ``dist_guide_p = 0`` and
  ``volume_phase_p = 1``.
- ``run_preset`` renders the still presets on the CPU (config1, two
  frames at its 640×360) and raises for the orbit presets, naming
  ROADMAP item 5, instead of rendering them with a still camera.

The bounds are equality; a mutant fails them: config3's temporal bias
correction changed, and the volume's reference keeping its guided
distance sampling.
"""
import inspect

import numpy as np
import pytest
import torch

from merian_quake_tpu import presets as j_presets
from merian_quake_tpu.utils import certify as j_certify
from merian_quake_tpu_torch import presets as t_presets
from merian_quake_tpu_torch.utils import certify as t_certify

torch.set_num_threads(min(2, torch.get_num_threads()))

NAMES = ["config1", "config2", "config3", "config4", "config5", "config6"]


def as_plain(x):
    """A config as nested (type name, fields) tuples, comparable across the
    two packages."""
    if x is None or isinstance(x, (int, float, str, bool)):
        return x
    if isinstance(x, tuple) and hasattr(x, "_asdict"):
        return (type(x).__name__, {k: as_plain(v) for k, v in x._asdict().items()})
    if isinstance(x, tuple):
        return tuple(as_plain(v) for v in x)
    raise TypeError(type(x))


def test_preset_names_match_jax():
    assert list(t_presets.PRESETS) == list(j_presets.PRESETS) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_preset_matches_jax(name):
    t, j = t_presets.PRESETS[name], j_presets.PRESETS[name]
    assert (t.name, t.description, t.frames) == (j.name, j.description, j.frames)
    assert as_plain(t.config) == as_plain(j.config)
    assert as_plain(t.integ_config) == as_plain(j.integ_config)
    tb, jb = t.make_bundle(device="cpu"), j.make_bundle()
    for field in ("v0", "v1", "v2", "texnum", "flags", "alpha"):
        t_arr, j_arr = getattr(tb.scene, field).numpy(), np.asarray(getattr(jb.scene, field))
        np.testing.assert_array_equal(t_arr, j_arr[: t_arr.shape[0]])
    for field in jb.uniforms._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tb.uniforms, field)),
                                      np.asarray(getattr(jb.uniforms, field)))
    if j.make_game is None:
        assert t.make_game is None
    else:
        orbit = inspect.getclosurevars(j.make_game).nonlocals
        assert t.make_game == t_presets.OrbitGame(tuple(orbit["center"]), orbit["radius"],
                                                  orbit["height"], orbit["animated"])


@pytest.mark.parametrize("name", NAMES)
def test_unguided_config_matches_jax(name):
    t, j = t_presets.PRESETS[name], j_presets.PRESETS[name]
    t_cfg, t_integ = t_certify._unguided_config(t.config, t.integ_config)
    j_cfg, j_integ = j_certify._unguided_config(j.config, j.integ_config)
    assert as_plain(t_cfg) == as_plain(j_cfg)
    assert as_plain(t_integ) == as_plain(j_integ)
    assert t_cfg.integrator == ("mcpg" if name == "config5" else "pt")


def test_mutants_fail(monkeypatch):
    """config3's temporal bias correction changed, and the volume's
    reference keeping its guided distance sampling: the equality fails."""
    p = t_presets.PRESETS["config3"]
    monkeypatch.setitem(t_presets.PRESETS, "config3",
                        p._replace(integ_config=p.integ_config._replace(temporal_bias_correction=2)))
    with pytest.raises(AssertionError):
        test_preset_matches_jax("config3")
    plain = t_certify._unguided_config

    def keeps_guiding(cfg, integ):
        c, i = plain(cfg, integ)
        return c, (i if i is None else i._replace(volume=i.volume._replace(dist_guide_p=0.5)))

    monkeypatch.setattr(t_certify, "_unguided_config", keeps_guiding)
    with pytest.raises(AssertionError):
        test_unguided_config_matches_jax("config5")


@pytest.mark.parametrize("name", ["config2", "config4", "config5"])
def test_orbit_presets_raise(name, monkeypatch):
    """The orbit presets raised NotImplementedError until the game loop
    was ported; they now run through ``run_preset`` (here at 32x16): the
    camera moves along the orbit, and the image is finite."""
    p = t_presets.PRESETS[name]
    monkeypatch.setitem(t_presets.PRESETS, name,
                        p._replace(config=p.config._replace(width=32, height=16)))
    state, out, spf = t_presets.run_preset(name, frames=2, device="cpu")
    assert out["ldr"].shape == (16, 32, 3) and bool(torch.isfinite(out["hdr"]).all())
    assert state.iteration == 2 and spf > 0.0


def test_run_preset_on_the_cpu():
    state, out, spf = t_presets.run_preset("config1", frames=2, device="cpu")
    assert out["ldr"].shape == (360, 640, 3) and bool(torch.isfinite(out["hdr"]).all())
    assert state.iteration == 2 and spf > 0.0 and float(out["ldr"].std()) > 0.01
