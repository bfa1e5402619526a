"""F7: the MCPG replay's segment sums repeat themselves bit for bit.

On the card ``ops/segments.py::compact_sums`` scans with
``chunked_scan`` (torch's row scan in chunks, an association fixed by
the shapes; torch's own scan of a single row is CUB's look-back scan,
which associates by timing). These tests run that scan on the CPU:
it equals ``torch.cumsum`` to rounding, repeats itself, and two
guided frames whose replays sum with it (at a chunk small enough that
the chunks nest) give an equal guiding table ``mc.f``, within rounding of
the frames that sum with ``torch.cumsum`` (and the light cache too). The card's reading (two
``frame_core`` runs from one state bit-equal, and the repair's cost
in turns) is chip_smoke's phase 29.
"""
import numpy as np
import pytest
import torch

from merian_quake_tpu_torch.models.procedural import cornell_box
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.ops import segments
from merian_quake_tpu_torch.render.mcpg import MCPGConfig
from merian_quake_tpu_torch.renderer import render_sequence

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.mark.parametrize("shape", [(1, 7), (1, 1024), (1, 1025), (3, 5000), (8, 70000)])
def test_chunked_scan_is_a_scan(shape):
    x = torch.from_numpy(np.random.default_rng(3).normal(size=shape).astype(np.float32))
    got = segments.chunked_scan(x)
    assert got.shape == x.shape
    ref = torch.cumsum(x.double(), dim=1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-4 * shape[1] ** 0.5)
    assert torch.equal(got, segments.chunked_scan(x.clone()))


def _replay_frames(monkeypatch, scan, chunk):
    monkeypatch.setattr(segments, "scan_rows", scan)
    monkeypatch.setattr(segments, "SCAN_CHUNK", chunk)
    state, _ = render_sequence(cornell_box(device="cpu"), RenderConfig(
        width=32, height=16, integrator="mcpg"), frames=3, mcpg_config=MCPGConfig(), device="cpu")
    return state.mcpg


def test_replay_repeats_with_the_cards_scan(monkeypatch):
    a = _replay_frames(monkeypatch, segments.chunked_scan, 16)
    b = _replay_frames(monkeypatch, segments.chunked_scan, 16)
    assert int((a.mc.sum_w > 0).sum()) > 0
    assert torch.equal(a.mc.f, b.mc.f) and torch.equal(a.mc.i, b.mc.i)
    assert torch.equal(a.lc.irr, b.lc.irr)
    ref = _replay_frames(monkeypatch, lambda x: torch.cumsum(x, dim=1), 16)
    assert torch.equal(a.mc.i, ref.mc.i)
    np.testing.assert_allclose(a.mc.f.numpy(), ref.mc.f.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a.lc.irr.numpy(), ref.lc.irr.numpy(), rtol=1e-4, atol=1e-5)


def test_replay_mutant_differs(monkeypatch):
    """A scan that drops each chunk's carry (the sum of the chunks before
    it) moves the guiding state (the light cache's irradiance): the
    comparison above can see a scan that is wrong."""
    def no_carry(x):
        r, m = x.shape
        b = -(-m // segments.SCAN_CHUNK)
        xp = torch.nn.functional.pad(x, (0, b * segments.SCAN_CHUNK - m))
        return torch.cumsum(xp.view(r * b, -1), dim=1).view(r, -1)[:, :m]

    ref = _replay_frames(monkeypatch, lambda x: torch.cumsum(x, dim=1), 16)
    bad = _replay_frames(monkeypatch, no_carry, 16)
    assert not np.allclose(bad.lc.irr.numpy(), ref.lc.irr.numpy(), rtol=1e-4, atol=1e-5)
