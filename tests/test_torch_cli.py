"""The port's command line against the JAX package's.

``render --scene box --size 32x16`` from both CLIs: the PNGs agree as
tests/test_torch_slice.py's frames do (≥ 99.5% of pixels within 1e-3 in
LDR), widened by the 8-bit quantization of the file (one step, 1/255);
a run with another seed (the mutant) does not. ``play --device cpu``
runs the live arena and writes its PNG and a savegame that a second
``play --load`` resumes; ``error`` prints the JAX CLI's numbers.
"""
import numpy as np
import pytest
import torch

from merian_quake_tpu import cli as j_cli
from merian_quake_tpu.utils.image import load_png
from merian_quake_tpu_torch import cli

torch.set_num_threads(min(2, torch.get_num_threads()))

QUANT = 1.0 / 255.0 + 1e-3


def _render(main, out, *extra):
    assert main([*extra, "render", "--scene", "box", "--size", "32x16", "--out", str(out)]) == 0
    return load_png(str(out)).astype(np.float64) / 255.0


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    return (_render(j_cli.main, d / "j.png", "--platform", "cpu"),
            _render(cli.main, d / "t.png", "--device", "cpu"), d)


def _agree(a, b):
    diff = np.abs(a - b)
    return bool((diff.max(-1) <= QUANT).mean() >= 0.995 and diff.mean() < 2e-3)


def test_render_matches_jax_cli(renders):
    j, t, _ = renders
    assert t.shape == j.shape == (16, 32, 3) and t.std() > 0.01
    assert _agree(t, j)


def test_render_mutant_fails(renders, tmp_path):
    j, _, _ = renders
    other = _render(cli.main, tmp_path / "m.png", "--device", "cpu")
    assert _agree(other, j)
    seeded = cli.main(["--device", "cpu", "render", "--scene", "box", "--size", "32x16",
                       "--seed", "7", "--out", str(tmp_path / "s.png")])
    assert seeded == 0
    assert not _agree(load_png(str(tmp_path / "s.png")).astype(np.float64) / 255.0, j)


def test_play_on_the_cpu_saves_and_loads(tmp_path, capsys):
    out, sav = tmp_path / "play.png", tmp_path / "play.sav"
    assert cli.main(["--device", "cpu", "play", "--size", "32x16", "--frames", "3",
                     "--out", str(out), "--save", str(sav)]) == 0
    img = load_png(str(out))
    assert img.shape == (16, 32, 3) and img.std() > 0
    first = capsys.readouterr().out
    assert "played 3 frames 32x16" in first and "saved game" in first
    assert cli.main(["--device", "cpu", "play", "--size", "32x16", "--frames", "2",
                     "--integrator", "mcpg", "--load", str(sav), "--out", str(out)]) == 0
    assert "loaded savegame" in capsys.readouterr().out


def test_error_matches_jax_cli(renders, capsys):
    _, _, d = renders
    args = ["error", str(d / "t.png"), str(d / "j.png")]
    assert cli.main(args) == 0
    ours = capsys.readouterr().out
    assert j_cli.main(args) == 0
    assert ours == capsys.readouterr().out and ours.startswith("rmse=")


def test_play_wav_and_props_match_jax(tmp_path):
    """``play --wav`` and ``--props``'s modules: the port's mixer, fed the
    JAX arena's sound events, writes the JAX mixer's WAV bytes; the
    property patches map onto the port's configs as onto the JAX
    package's. A mixer fed one event less (the mutant) writes other bytes."""
    from merian_quake_tpu.game.audio import AudioMixer as JMixer
    from merian_quake_tpu.game.live import angle_vectors
    from merian_quake_tpu.game.mod import make_arena as j_make_arena
    from merian_quake_tpu.models.types import RenderConfig as JConfig
    from merian_quake_tpu.render.mcpg import MCPGConfig as JMCPGConfig
    from merian_quake_tpu.utils.props import apply_patches as j_apply
    from merian_quake_tpu_torch.game.audio import AudioMixer
    from merian_quake_tpu_torch.models.types import RenderConfig
    from merian_quake_tpu_torch.render.mcpg import MCPGConfig
    from merian_quake_tpu_torch.utils.props import apply_patches

    live = j_make_arena(dynamic_capacity=256)
    frames = []
    for i in range(40):
        live.step(1 / 30, forward=150.0, yaw=20.0 + 3 * i, attack=i % 5 == 0)
        ps = live.host.player_state()
        _, right, _ = angle_vectors(ps.view_angles)
        frames.append((live.host.time, live.host.frame_sound_events(), ps.origin + ps.view_ofs,
                       right))
    assert sum(len(f[1]) for f in frames) > 0

    def wav(mixer_type, drop=False):
        m = mixer_type()
        for t, events, listener, right in frames:
            m.frame(t, events[1:] if drop and events else events, listener, right)
        m.set_ambients(live.host.ambient_sounds())
        path = str(tmp_path / f"{mixer_type.__module__}{drop}.wav")
        m.write_wav(path, duration=live.host.time, listener=frames[-1][2], right=frames[-1][3])
        with open(path, "rb") as f:
            return f.read()

    ours = wav(AudioMixer)
    assert ours == wav(JMixer) and len(ours) > 1000
    assert wav(AudioMixer, drop=True) != ours
    patches = {"spp": 2, "mcpg.surf_bsdf_p": 0.3, "volume.volume_spp": 2, "nope": 1, "width": 64}
    t = apply_patches(RenderConfig(), MCPGConfig(), patches)
    j = j_apply(JConfig(), JMCPGConfig(), patches)
    assert (t[0].spp, t[0].width, t[1].surf_bsdf_p, t[2], t[3]) == (
        j[0].spp, j[0].width, j[1].surf_bsdf_p, j[2], j[3])
