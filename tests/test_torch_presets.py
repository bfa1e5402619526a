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

- ``run_preset`` runs every preset through one ``renderer.compile_frame``
  (on the card one CUDA graph; on the CPU frame_core a call with the
  alpha loop's test on the device): at 32×16 its frames equal the eager
  loop's (``frame_core`` a frame, a new ``build_accel`` each orbit frame)
  bit for bit, state and outputs. An orbit preset writes each frame's
  accel into the tables its frame was compiled on
  (``accel.build.write_accel``): every table, its packed rows and the
  tables derived from it keep their storage and take the new values; an
  accel of another structure (a table missing, another shape, the
  shadow table aliasing ``woop_w`` in one and not the other) raises. The
  card's side is chip_smoke's phases 26 and 33.

The bounds are equality; a mutant fails them: config3's temporal bias
correction changed, and the volume's reference keeping its guided
distance sampling; a write that leaves the derived tables as they were.
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


def _eager_preset(name, frames):
    """What run_preset rendered before it compiled its frame: frame_core a
    frame, the orbit presets on a new build_accel each frame."""
    from merian_quake_tpu_torch.accel.build import build_accel, scene_features
    from merian_quake_tpu_torch.renderer import frame_core, init_state

    p = t_presets.PRESETS[name]
    bundle = p.make_bundle(device="cpu")
    config = p.config._replace(features=scene_features(bundle.scene, bundle.uniforms,
                                                       bundle.atlas))
    game = p.make_game(bundle) if p.make_game is not None else None
    state = init_state(config, p.integ_config, device="cpu")
    atlas = bundle.atlas if game is None else game.static_bundle.atlas
    accel = build_accel(bundle.scene, atlas) if game is None else None
    for i in range(frames):
        if game is not None:
            scene, u = game.step(1.0 / 30.0)
            accel = build_accel(scene, atlas)
        else:
            u = bundle.uniforms._replace(frame=i)
        state, out = frame_core(accel, atlas, u, config, state, mcpg_config=p.integ_config)
    return state, out


def _same_bits(a, b):
    from merian_quake_tpu_torch.capture import skeleton, tree_leaves

    assert skeleton(a) == skeleton(b)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", NAMES)
def test_run_preset_compiled_equals_eager(name, monkeypatch):
    """Each preset at 32×16, 3 frames: run_preset makes one compiled frame
    and calls it a frame; its final state and outputs equal the eager
    loop's bit for bit (the orbit presets: the camera moves and, config5,
    the alias model)."""
    from merian_quake_tpu_torch import renderer

    p = t_presets.PRESETS[name]
    monkeypatch.setitem(t_presets.PRESETS, name,
                        p._replace(config=p.config._replace(width=32, height=16)))
    made, calls = [], []
    plain_init, plain_call = renderer.CompiledFrame.__init__, renderer.CompiledFrame.__call__
    monkeypatch.setattr(renderer.CompiledFrame, "__init__",
                        lambda self, *a, **k: (made.append(self), plain_init(self, *a, **k))[1])
    monkeypatch.setattr(renderer.CompiledFrame, "__call__",
                        lambda self, u: (calls.append(u), plain_call(self, u))[1])
    state, out, _ = t_presets.run_preset(name, frames=3, device="cpu")
    assert len(made) == 1 and len(calls) == 3
    want_state, want_out = _eager_preset(name, 3)
    _same_bits(state, want_state)
    _same_bits(out, want_out)


def _orbit_accels(frames=2):
    """config5's orbit (the fogged court, the animated model): the accels
    of ``frames`` steps, each a new build_accel."""
    from merian_quake_tpu_torch.accel.build import build_accel

    p = t_presets.PRESETS["config5"]
    game = p.make_game(p.make_bundle(device="cpu"))
    return [build_accel(game.step(1.0 / 30.0)[0], game.static_bundle.atlas)
            for _ in range(frames)]


def _derived(acc):
    """What the tracers keep on the accel's tables, made as a trace makes
    it: the padded bounds and walk boxes of every table, K8's table."""
    from merian_quake_tpu_torch.accel import dense, woop

    got = {"mt_table": dense.scene_table(acc)}
    for name, (lo, hi) in {"": (acc.cluster_lo, acc.cluster_hi),
                           "alpha": (acc.cluster_lo_alpha, acc.cluster_hi_alpha),
                           "proxy": (acc.cluster_lo_proxy, acc.cluster_hi_proxy)}.items():
        if lo is not None:
            plo, phi = woop.padded_bounds(lo, hi)
            got[f"{name}.padded_lo"], got[f"{name}.padded_hi"] = plo, phi
            got[f"{name}.boxes"] = woop.walk_boxes(plo, phi, 64, 8)
    return got


def test_write_accel_keeps_storage_and_takes_values():
    """write_accel(a, b): every tensor of ``a``, its packed rows and what
    the tracers derived from it keep their storage and equal ``b``'s (and
    a fresh derivation from ``b``); the next frame's accel differs from
    this one (the content moves)."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.accel.build import WOOP_TABLES, _fields, write_accel

    a, b = _orbit_accels()
    assert any(not torch.equal(x, y) for (_, x), (_, y) in zip(_fields(a), _fields(b))
               if x is not None)
    held = {**dict(_fields(a)), **{f"{k}.rows4": woop.packed_rows(getattr(a, k))
                                   for k in WOOP_TABLES if getattr(a, k) is not None},
            **_derived(a)}
    assert write_accel(a, b) is a
    now = {**dict(_fields(a)), **{f"{k}.rows4": woop.packed_rows(getattr(a, k))
                                  for k in WOOP_TABLES if getattr(a, k) is not None},
           **_derived(a)}
    want = {**dict(_fields(b)), **{f"{k}.rows4": woop.packed_rows(getattr(b, k))
                                   for k in WOOP_TABLES if getattr(b, k) is not None},
            **_derived(b)}
    assert held.keys() == now.keys() == want.keys()
    for k in held:
        if held[k] is None:
            assert now[k] is None and want[k] is None
            continue
        assert now[k] is held[k] and now[k].data_ptr() == held[k].data_ptr(), k
        assert torch.equal(now[k], want[k]), k


def test_write_accel_mutant_stale_derived_fails(monkeypatch):
    """A write that leaves the derived tables as they were: they no longer
    match the tables (the box, then the box moved by one unit)."""
    from merian_quake_tpu_torch.accel import woop
    from merian_quake_tpu_torch.accel.build import build_accel, write_accel
    from merian_quake_tpu_torch.models.procedural import cornell_box

    box = cornell_box(device="cpu")
    moved = box.scene._replace(**{k: getattr(box.scene, k) + 1.0 for k in ("v0", "v1", "v2")})
    a, b = build_accel(box.scene, box.atlas), build_accel(moved, box.atlas)
    _derived(a)
    monkeypatch.setattr(woop, "rewrite_cached", lambda owner: None)
    write_accel(a, b)
    stale = [k for k, x in _derived(a).items() if not torch.equal(x, _derived(b)[k])]
    assert {".padded_lo", ".boxes", "mt_table"} <= set(stale), stale


@pytest.mark.parametrize("change", ["missing", "shape", "alias"])
def test_write_accel_refuses_another_structure(change):
    """A table missing, another shape, or the shadow table aliasing woop_w
    in one accel and not in the other: write_accel raises, and writes
    nothing."""
    from merian_quake_tpu_torch.accel.build import write_accel
    from merian_quake_tpu_torch.models.procedural import cornell_box
    from merian_quake_tpu_torch.accel.build import build_accel

    box = cornell_box(device="cpu")
    a = build_accel(box.scene, box.atlas)
    assert a.woop_w_shadow is a.woop_w
    b = build_accel(box.scene, box.atlas)
    if change == "missing":
        b = b._replace(woop_w_alpha=torch.zeros_like(b.woop_w))
    elif change == "shape":
        b = b._replace(tri_attr=b.tri_attr[:-64])
    else:
        b = b._replace(woop_w_shadow=b.woop_w.clone())
    before = a.tri_attr.clone()
    with pytest.raises(ValueError, match="differ in structure"):
        write_accel(a, b)
    assert torch.equal(a.tri_attr, before)


@pytest.mark.cuda
def test_run_preset_captured_equals_eager_on_the_card():
    """run_preset of every preset captured against eager on the card,
    every frame's ldr and hdr bit for bit: the card's machine has no JAX,
    so chip_smoke phases 26 (config1, config3, config6) and 33 (config2,
    config4, config5) make these comparisons."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    state, out, _ = t_presets.run_preset("config1", frames=2, device="cuda")
    assert bool(torch.isfinite(out["hdr"]).all())
