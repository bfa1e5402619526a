"""The game layer, port against the JAX package.

- Loaders and generators: ``dungeon(seed, grid=3)``'s scene arrays,
  atlas and entity lump, ``build_progs()``'s bytes, the mdl and spr
  write-then-load round trips: equal.
- The two native hosts: the JAX package loads the tracked
  ``native/libmq_game.so``, the port builds its own from
  ``native/game/*.cc`` (native/Makefile's flags). Both boot
  ``make_arena`` and step 30 frames with the same usercmds: entity
  snapshots, ``player_state``, HUD stats, the event streams (prints,
  centerprints, sounds, particles) and the dynamic blocks are bit-equal.
- A savegame written by the JAX host, loaded into the port's, steps on
  identically.
- The orbit presets (config2, config4, config5): ``OrbitGame(bundle)``'s
  GameState steps the scenes and uniforms of the JAX package's
  ``make_game(bundle)`` for 4 frames.
Each comparison has a mutant that fails it.
"""
import numpy as np
import pytest
import torch

from merian_quake_tpu import presets as j_presets
from merian_quake_tpu.game.mod import build_progs as j_build_progs
from merian_quake_tpu.game.mod import make_arena as j_make_arena
from merian_quake_tpu.models import mdl as j_mdl
from merian_quake_tpu.models import spr as j_spr
from merian_quake_tpu.models.dungeon import dungeon as j_dungeon
from merian_quake_tpu_torch import presets
from merian_quake_tpu_torch.game import host as t_host
from merian_quake_tpu_torch.game.mod import build_progs, make_arena
from merian_quake_tpu_torch.models import mdl, spr
from merian_quake_tpu_torch.models.dungeon import dungeon

torch.set_num_threads(min(2, torch.get_num_threads()))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _differ(a: dict, b: dict) -> list:
    """Keys whose values are not equal (arrays bit for bit)."""
    assert set(a) == set(b)
    return [k for k in a if not (np.shape(a[k]) == np.shape(b[k]) and np.array_equal(
        np.asarray(a[k]), np.asarray(b[k])))]


# ---------------------------------------------------------------- loaders


def _atlas_close(ours, ref):
    """The atlas texels as tests/test_torch_accel.py holds them: the sRGB
    decode is numpy's f32 pow against XLA's, a few ulps apart."""
    np.testing.assert_allclose(_np(ours.data), np.asarray(ref.data), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def dungeons():
    return j_dungeon(seed=3, grid=3), dungeon(seed=3, grid=3, device="cpu")


def _dungeon_record(d):
    rec = {f"scene.{f}": _np(getattr(d.bundle.scene, f)) for f in d.bundle.scene._fields}
    rec.update({f"uniforms.{f}": _np(getattr(d.bundle.uniforms, f))
                for f in d.bundle.uniforms._fields})
    rec["atlas.table"] = _np(d.bundle.atlas.table)
    rec["hull_boxes"] = np.asarray(d.hull_boxes, np.float64)
    rec["bounds"] = np.asarray(d.bounds, np.float64)
    rec["rooms"], rec["torches"] = d.rooms, d.torches
    rec["entity_lump"] = np.frombuffer(d.entity_lump.encode(), np.uint8)
    return rec


def test_dungeon_matches_jax(dungeons):
    j, t = dungeons
    assert t.bundle.scene.num_tris > 30000
    assert _differ(_dungeon_record(j), _dungeon_record(t)) == []
    _atlas_close(t.bundle.atlas, j.bundle.atlas)


def test_dungeon_mutant_fails(dungeons):
    j, _ = dungeons
    other = dungeon(seed=4, grid=3, device="cpu")
    assert "scene.v0" in _differ(_dungeon_record(j), _dungeon_record(other))


def test_build_progs_matches_jax():
    assert build_progs() == j_build_progs()
    assert len(build_progs()) > 1000


def _mdl_args(rng):
    skins = [rng.integers(0, 256, (8, 16), dtype=np.uint8)]
    frames = rng.uniform(-20, 20, (3, 5, 3)).astype(np.float32)
    return (skins, rng.integers(0, 16, 5), rng.integers(0, 8, 5), np.asarray([0, 32, 0, 0, 32]),
            np.asarray([[0, 1, 2], [1, 2, 3], [2, 3, 4]]), np.asarray([1, 0, 1]), frames,
            np.asarray([0.25, 0.25, 0.25], np.float32), np.asarray([-20.0, -20.0, -20.0], np.float32))


def test_mdl_and_spr_roundtrips_match_jax():
    rng = np.random.default_rng(11)
    args = _mdl_args(rng)
    blob = mdl.write_mdl(*args)
    assert blob == j_mdl.write_mdl(*args)
    t_m, j_m = mdl.load_mdl(blob, "m"), j_mdl.load_mdl(blob, "m")
    for f in j_m._fields:
        a, b = getattr(t_m, f), getattr(j_m, f)
        if isinstance(b, list):
            assert all(np.array_equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
    frames = [rng.integers(0, 256, (6, 4), dtype=np.uint8), rng.integers(0, 256, (3, 5), dtype=np.uint8)]
    sblob = spr.write_spr(frames)
    assert sblob == j_spr.write_spr(frames)
    t_s, j_s = spr.load_spr(sblob, "s"), j_spr.load_spr(sblob, "s")
    assert len(t_s.frames) == len(j_s.frames) == 2
    for a, b in zip(t_s.frames, j_s.frames):
        for f in b._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))


# ---------------------------------------------------------------- hosts

FRAMES = 30


def _usercmds(seed=5):
    rng = np.random.default_rng(seed)
    return [dict(dt=1 / 30, forward=float(rng.uniform(-200, 200)),
                 side=float(rng.uniform(-100, 100)), yaw=float(rng.uniform(0, 360)),
                 pitch=float(rng.uniform(-20, 20)), attack=i % 7 == 0, jump=i % 11 == 0,
                 impulse=2 if i == 4 else 0) for i in range(FRAMES)]


def _host_record(live, dyn, client=True) -> dict:
    """One frame of a host: snapshot, player state, HUD, events, and with
    ``client`` the LiveGame's own state built on them (the overlays and
    the dynamic block: pose blends and particles live in the LiveGame,
    not in the host or its savegame)."""
    h = live.host
    s = h.snapshot()
    rec = {f"snap.{f}": getattr(s, f) for f in s.__dataclass_fields__}
    ps = h.player_state()
    rec.update({f"player.{f}": np.asarray(getattr(ps, f)) for f in ps.__dataclass_fields__})
    rec.update({f"hud.{f}": np.asarray(v, np.float64) for f, v in live.hud_state()._asdict().items()})
    rec["time"] = np.float64(h.time)
    rec["prints"] = np.asarray(h.prints() + ["|"] + h.centerprints())
    rec["sounds"] = np.asarray([repr(e[:5]) + repr(e[5].tolist()) for e in h.frame_sound_events()])
    rec.update({f"particles.{i}": a for i, a in enumerate(h.frame_particles())})
    if client:
        rec["overlays"] = np.asarray([k + v for k, v in live.overlay_texts()])
        rec.update({f"dyn.{k}": v for k, v in dyn.items()})
    return rec


def _run(live, cmds, first=0, client=True):
    out = []
    for i, kw in enumerate(cmds):
        dyn, _ = live.step_dynamic(**kw)
        out.append((first + i, _host_record(live, dyn, client)))
    return out


def _compare(j_recs, t_recs):
    bad = [(i, k) for (i, a), (_, b) in zip(j_recs, t_recs) for k in _differ(a, b)]
    return bad


@pytest.fixture(scope="module")
def hosts():
    cmds = _usercmds()
    j, t = j_make_arena(dynamic_capacity=512), make_arena(dynamic_capacity=512, device="cpu")
    return cmds, _run(j, cmds), _run(t, cmds)


def test_port_builds_its_own_host_library():
    path = t_host.build_library()
    assert path.startswith(t_host.BUILD_DIR) and "libmq_game_" in path
    assert "native" not in path.split("_build")[1]


def test_hosts_step_bit_for_bit(hosts):
    """Both packages' arenas, 30 frames of the same usercmds (moving,
    turning, firing, jumping, an impulse): every record equal."""
    cmds, j_recs, t_recs = hosts
    assert len(j_recs) == len(t_recs) == FRAMES
    assert _compare(j_recs, t_recs) == []
    # the run is not idle: entities move and the player walks
    assert not np.array_equal(j_recs[0][1]["snap.origins"], j_recs[-1][1]["snap.origins"])
    assert not np.array_equal(j_recs[0][1]["player.origin"], j_recs[-1][1]["player.origin"])


def test_hosts_mutant_fails(hosts):
    """The port's host given one other usercmd (frame 3 turned by 1
    degree): the records part from that frame on."""
    cmds, j_recs, _ = hosts
    mut = [dict(kw) for kw in cmds]
    mut[3]["yaw"] += 1.0
    t_recs = _run(make_arena(dynamic_capacity=512, device="cpu"), mut)
    bad = _compare(j_recs, t_recs)
    assert bad and min(i for i, _ in bad) == 3


def test_savegame_from_the_jax_host_steps_on_identically(tmp_path):
    """A savegame written by the JAX host, loaded into the port's host,
    steps on as the JAX host does (the host's records: the savegame holds
    the host's state, not the LiveGame's client state); a port host that
    did not load it (the mutant) does not."""
    cmds = _usercmds(seed=9)
    j = j_make_arena(dynamic_capacity=256)
    _run(j, cmds[:15])
    path = str(tmp_path / "j.sav")
    j.host.save(path)
    t = make_arena(dynamic_capacity=256, device="cpu")
    t.host.load(path)
    assert t.host.time == j.host.time
    j_recs, t_recs = _run(j, cmds[15:], 15, False), _run(t, cmds[15:], 15, False)
    assert _compare(j_recs, t_recs) == []
    fresh = _run(make_arena(dynamic_capacity=256, device="cpu"), cmds[15:], 15, False)
    assert _compare(j_recs, fresh)


# ---------------------------------------------------------------- orbit presets

ORBITS = ["config2", "config4", "config5"]


def _orbit_records(name, port=True, orbit=None):
    if port:
        p = presets.PRESETS[name]
        bundle = p.make_bundle(device="cpu")
        gs = (orbit or p.make_game)(bundle)
    else:
        p = j_presets.PRESETS[name]
        gs = p.make_game(p.make_bundle())
    recs = []
    for _ in range(4):
        scene, u = gs.step(1.0 / 30.0)
        rec = {f"scene.{f}": _np(getattr(scene, f)) for f in scene._fields}
        rec.update({f"uniforms.{f}": _np(getattr(u, f)) for f in u._fields})
        rec["uniforms.frame"] = np.int64(u.frame)
        rec["uniforms.player"] = np.int64(u.player)
        rec["atlas.table"] = _np(gs.static_bundle.atlas.table)
        recs.append((len(recs), rec))
    return recs, gs.static_bundle.atlas


@pytest.mark.parametrize("name", ORBITS)
def test_orbit_game_steps_match_jax(name):
    (j_recs, j_atlas), (t_recs, t_atlas) = _orbit_records(name, port=False), _orbit_records(name)
    assert _compare(j_recs, t_recs) == []
    _atlas_close(t_atlas, j_atlas)
    assert not np.array_equal(t_recs[0][1]["uniforms.cam_x"], t_recs[-1][1]["uniforms.cam_x"])
    if name == "config5":  # the bouncing alias model is in the dynamic block
        assert int(t_recs[0][1]["scene.valid"].sum()) > int(
            _np(presets.PRESETS[name].make_bundle(device="cpu").scene.valid).sum())


def test_orbit_game_mutant_fails():
    """config5's orbit with its height off by one unit: the camera parts."""
    o = presets.PRESETS["config5"].make_game
    bad = _compare(_orbit_records("config5", port=False)[0],
                   _orbit_records("config5", orbit=o._replace(height=o.height + 1))[0])
    assert ("uniforms.cam_x" in {k for _, k in bad})
