"""Certification (utils/certify.py): twins of tests/test_certify.py's
config1 and config6 cases on the port, and its numbers against the JAX
package's at the same arguments, on the CPU.

The JAX package's values and its own spread come from
``scripts/certify_jax_values.py`` (its jitted run, and its op-by-op run
under ``jax.disable_jit``); config1's jitted value is also read here, in
the test, from the JAX package itself.

- config1 at ``scale=0.08`` (48×24), 64 truth frames in 4 runs: relMSE
  finite, ``ratio_vs_pt == 1.0`` (PT against itself), 8 frames better
  than 2; relMSE and trimmed relMSE within rtol 1e-6 of the JAX
  package's (its own spread: 1.2e-8 at 8 frames, 1.9e-8 at 2; the port
  reads 1.7e-8 and 1.8e-8).
- config6 at ``scale=0.1`` (64×32), 12 frames, 64 truth frames in 2
  runs: ``ratio_vs_pt < 1`` (tests/test_certify.py's criterion for the
  guiding-bound preset); relMSE, the equal-budget PT relMSE and the
  ratio within rtol 1e-6 of the JAX package's jitted values (its spread:
  1.1e-7, 1.4e-7, 3.4e-8; the port reads 1.1e-7, 1.4e-7, 4.2e-8).
- ``steady_skip``: config3 (ReSTIR) at ``scale=0.05`` (96×48), 20
  frames, the measurement restarted at frame 16, 16 truth frames: relMSE
  within 1.25× the JAX package's own spread (1.66e-3 relative; the port
  reads 1.66e-3, and 7.7e-8 against the op-by-op run) of its jitted
  value, the equal-budget PT relMSE within rtol 1e-6 (spread 3.6e-8).

Every run goes through ``renderer.compile_frame`` (on the card one CUDA
graph): ``_run`` equals the eager ``frame_core`` loop bit for bit on the
CPU (PT, ReSTIR with the steady skip, MCPG; frame numbers from
4,000,000), one compiled frame a run, a call a frame. The card's side
(captured against eager, relMSEs equal to the bit) is chip_smoke.py's
phase 26.

Mutants, each failing its bound: the truth's frame numbers kept in 19
bits (1,000,000 → 475,712, so the truth's streams are other streams),
a steady skip that keeps the frame counter (the accumulators restart,
their 1/N weights do not), and one that never reaches the compiled
frame (the accumulators keep accumulating).
"""
import csv

import numpy as np
import pytest
import torch

from merian_quake_tpu.utils.certify import certify_presets as j_certify_presets
from merian_quake_tpu_torch.utils import certify as t_certify

torch.set_num_threads(min(2, torch.get_num_threads()))

# scripts/certify_jax_values.py, the JAX package's jitted run
JAX_CONFIG6 = {"relmse": 23.436782936872547, "relmse_pt_equal_budget": 32.21251612033831,
               "ratio_vs_pt": 0.7275675966856576}
JAX_CONFIG3_SKIP = {"relmse": 1.4439532737997685, "relmse_pt_equal_budget": 16.28589428633066}
CONFIG3_SKIP_SPREAD = 0.0016612432701317117
RTOL = 1e-6


def config1(frames, **kw):
    return t_certify.certify_presets(names=["config1"], scale=0.08, frames=frames, ref_frames=64,
                                     device="cpu", **kw)["config1"]


def config6():
    return t_certify.certify_presets(names=["config6"], scale=0.1, frames=12, ref_frames=64,
                                     ref_runs=2, device="cpu")["config6"]


def config3_skip():
    return t_certify.certify_presets(names=["config3"], scale=0.05, frames=20, ref_frames=16,
                                     ref_runs=1, steady_skip=16, device="cpu")["config3"]


def close(got, want, rtol):
    assert abs(got - want) <= rtol * abs(want), (got, want, abs(got - want) / abs(want))


@pytest.fixture(scope="module")
def jax_config1():
    return {n: j_certify_presets(names=["config1"], scale=0.08, frames=n, ref_frames=64)["config1"]
            for n in (8, 2)}


def config1_agrees(r, ref):
    for key in ("relmse", "relmse_trimmed"):
        close(r[key], ref[key], RTOL)


def test_certify_config1_small(jax_config1, tmp_path):
    """config1 (plain PT): a finite relMSE that DECREASES with more frames
    (convergence), the JAX package's numbers, keys and convergence file."""
    r8 = config1(8, out_path=str(tmp_path / "cert.json"), convergence_dir=str(tmp_path))
    assert np.isfinite(r8["relmse"]) and r8["relmse"] > 0.0
    assert r8["ratio_vs_pt"] == 1.0  # PT vs itself at equal budget
    r2 = config1(2)
    assert r8["relmse"] < r2["relmse"]
    for r, n in ((r8, 8), (r2, 2)):
        config1_agrees(r, jax_config1[n])
    assert set(r2) == set(jax_config1[2]) and r8["resolution"] == "48x24"
    with open(r8["convergence_csv"]) as f:
        rows = list(csv.DictReader(f))
    assert [int(row["frames"]) for row in rows] == [1, 2, 4, 8]
    assert float(rows[-1]["relmse"]) == pytest.approx(r8["relmse"], rel=1e-5)


def test_certify_guiding_bound_alcove_beats_pt():
    """config6 (occluded-light alcove + MCPG): guiding must BEAT plain PT
    at equal budget, and give the JAX package's numbers."""
    r = config6()
    assert np.isfinite(r["relmse"])
    assert r["ratio_vs_pt"] < 1.0, r
    for key, want in JAX_CONFIG6.items():
        close(r[key], want, RTOL)


def config3_agrees(r):
    close(r["relmse"], JAX_CONFIG3_SKIP["relmse"], 1.25 * CONFIG3_SKIP_SPREAD)
    close(r["relmse_pt_equal_budget"], JAX_CONFIG3_SKIP["relmse_pt_equal_budget"], RTOL)


def test_certify_steady_skip_matches_jax():
    r = config3_skip()
    assert r["steady_skip"] == 16 and r["frames"] == 20 and r["integrator"] == "restir"
    config3_agrees(r)


def test_equal_time_keys():
    """``equal_time`` adds the frame times and the reference at equal
    time; PT against itself is 1 at equal time too."""
    r = config1(2, equal_time=True)
    assert r["ms_per_frame"] > 0 and r["ref_ms_per_frame"] > 0
    assert r["ratio_vs_pt_equal_time"] == 1.0 and r["pt_equal_time_frames"] == 2


def _eager_run(bundle, config, integ, frames, frame_offset, steady_skip):
    """What ``_run`` computed before it compiled its frame: frame_core a
    frame (the eager alpha loop), the steady skip by ``_replace``."""
    from merian_quake_tpu_torch.accel.build import build_accel
    from merian_quake_tpu_torch.renderer import frame_core, init_state

    accel = build_accel(bundle.scene, bundle.atlas, device="cpu")
    state = init_state(config, integ, device="cpu")
    for i in range(frames):
        if steady_skip and i == steady_skip:
            z = torch.zeros_like
            state = state._replace(accum_irradiance=z(state.accum_irradiance),
                                   accum_direct=z(state.accum_direct),
                                   accum_albedo=z(state.accum_albedo),
                                   iteration=z(state.iteration))
        state, out = frame_core(accel, bundle.atlas,
                                bundle.uniforms._replace(frame=frame_offset + i), config, state,
                                mcpg_config=integ)
    return out["hdr"].numpy()


@pytest.mark.parametrize("name,skip", [("config1", 0), ("config3", 3), ("config6", 0)])
def test_run_compiled_equals_eager_loop(name, skip, monkeypatch):
    """``_run`` through one compiled frame equals the eager loop bit for
    bit, the snapshots too, at frame numbers 4,000,000 on (certify's
    truth offsets reach 4,000,000 + frames)."""
    from merian_quake_tpu_torch import renderer
    from merian_quake_tpu_torch.accel.build import scene_features
    from merian_quake_tpu_torch.presets import PRESETS

    p = PRESETS[name]
    bundle = p.make_bundle(device="cpu")
    cfg = p.config._replace(width=32, height=16, denoise=False, features=scene_features(
        bundle.scene, bundle.uniforms, bundle.atlas))
    made, calls = [], []
    plain_init, plain_call = renderer.CompiledFrame.__init__, renderer.CompiledFrame.__call__
    monkeypatch.setattr(renderer.CompiledFrame, "__init__",
                        lambda self, *a, **k: (made.append(self), plain_init(self, *a, **k))[1])
    monkeypatch.setattr(renderer.CompiledFrame, "__call__",
                        lambda self, u: (calls.append(u.frame), plain_call(self, u))[1])
    final, snaps = t_certify._run(bundle, cfg, p.integ_config, 6, frame_offset=4_000_000,
                                  snapshots=[1, 2, 4], steady_skip=skip, device="cpu")
    assert len(made) == 1 and calls == [4_000_000 + i for i in range(6)]
    np.testing.assert_array_equal(final, _eager_run(bundle, cfg, p.integ_config, 6, 4_000_000,
                                                    skip))
    assert sorted(snaps) == [1, 2, 4]
    np.testing.assert_array_equal(snaps[4], _eager_run(bundle, cfg, p.integ_config, 4, 4_000_000,
                                                       skip))


def test_certify_script_row_suffix(tmp_path):
    """scripts/certify_torch.py merges each row into --out under the
    preset's name plus --row-suffix, keeping the rows already there."""
    import importlib.util
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "certify_torch.py")
    spec = importlib.util.spec_from_file_location("certify_torch", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = tmp_path / "cert.json"
    out.write_text(json.dumps({"config1": {"kept": True}}))
    args = ["--presets", "config1", "--scale", "0.05", "--frames", "2", "--ref-frames", "4",
            "--ref-runs", "1", "--device", "cpu", "--out", str(out)]
    assert script.main(args + ["--row-suffix", "_small"]) == 0
    rows = json.loads(out.read_text())
    assert rows["config1"] == {"kept": True} and rows["config1_small"]["resolution"] == "32x16"


@pytest.mark.cuda
def test_certify_captured_equals_eager_on_the_card():
    """certify_presets captured against eager on the card, each relMSE
    equal to the bit (config1, config6 and config3's steady skip): the
    card's machine has no JAX, so chip_smoke.py phase 26 makes this
    comparison."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    r = t_certify.certify_presets(["config1"], scale=0.08, frames=4, ref_frames=8, ref_runs=1,
                                  device="cuda")["config1"]
    assert r["ratio_vs_pt"] == 1.0


def test_mutant_frame_offsets_fail(jax_config1, monkeypatch):
    """The truth's frame numbers kept in 19 bits."""
    plain = t_certify._run
    monkeypatch.setattr(t_certify, "_run", lambda *a, frame_offset=0, **k: plain(
        *a, frame_offset=frame_offset & 0x7FFFF, **k))
    with pytest.raises(AssertionError):
        config1_agrees(config1(8), jax_config1[8])


def test_mutant_steady_skip_fails(monkeypatch):
    """The steady skip keeps the frame counter (the accumulators restart,
    their 1/N weights do not)."""
    plain = t_certify._restart_accumulation
    monkeypatch.setattr(t_certify, "_restart_accumulation",
                        lambda state: plain(state)._replace(iteration=state.iteration))
    with pytest.raises(AssertionError):
        config3_agrees(config3_skip())


def test_mutant_steady_skip_ignored_fails(monkeypatch):
    """A restart that never reaches the compiled frame (a new state made
    with ``_replace`` that the frame does not render from): the
    accumulators silently keep accumulating."""
    import merian_quake_tpu_torch.renderer as renderer

    monkeypatch.setattr(renderer.CompiledFrame, "set_state", lambda self, state: None)
    with pytest.raises(AssertionError):
        config3_agrees(config3_skip())
