"""The port's tracer (utils/profiler.py) at its layer boundaries, on the
CPU. The port has no JAX twin of these spans: its tracer replaces the
synchronizing spans of the JAX package's profiler, whose own test
(tests/test_utils.py) is left as it is.

- Off (no torch.profiler session, no enabled Profiler installed), a
  40×24 CPU frame makes no event and records nothing.
- Under ``torch.profiler.profile()``, two compiled 40×24 frames of the
  fogged court record the table's spans: MCPG with the volume pass
  (gbuffer, the pack, the surface pass and its segments, the volume pass,
  the update, post and its children) and ReSTIR with the denoise chain
  (restir and its passes, the surface SVGF, exposure, TAA, FXAA), each
  with its parent and in both frames, each span's self time its time
  less its children's; the profiler's events hold the ``mq.*`` ranges;
  the frames' state and outputs equal those rendered with the tracer
  off, bit for bit.
- The counters: ``mcpg.lanes_live`` is ``SurfaceResult.live_in.sum()``
  and ``mcpg.lanes_run`` the segments times the lanes; with a small
  update queue ``mcpg.update_rows_dropped`` is the live rows past the
  capacity, counted by hand.
- A live arena frame: the game step's and the refresh's host spans open
  the frame the compiled frame closes, one id a frame.
The captured frame's side (the stage table of the graph, the events that
tile the replay, recorded and not bit-equal) is chip_smoke's phase 28.
"""
import pytest
import torch

from merian_quake_tpu_torch.accel.build import build_accel, scene_features
from merian_quake_tpu_torch.capture import tree_leaves
from merian_quake_tpu_torch.models.procedural import outdoor_court
from merian_quake_tpu_torch.models.types import RenderConfig
from merian_quake_tpu_torch.render.mcpg import MCPGConfig
from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig
from merian_quake_tpu_torch.render.restir import ReSTIRConfig
from merian_quake_tpu_torch.renderer import compile_frame, init_state, render_frame
from merian_quake_tpu_torch.utils import profiler

torch.set_num_threads(min(2, torch.get_num_threads()))

SMALL = dict(mc_adaptive_size=1 << 12, mc_static_size=1 << 10, lc_size=1 << 12,
             update_cell_capacity=1 << 12, update_queue_capacity=1 << 14,
             zero_queue_capacity=1 << 10, lc_queue_capacity=1 << 14)

MCPG_SPANS = {
    "gbuffer": None, "mcpg.pack": None, "mcpg.surface": None,
    "mcpg.surface.seg0": "mcpg.surface", "mcpg.surface.seg1": "mcpg.surface",
    "mcpg.volume": None, "mcpg.update": None, "post": None, "post.accumulate": "post",
    "post.exposure": "post",
}
RESTIR_SPANS = {
    "gbuffer": None, "restir": None, "restir.generate": "restir", "restir.temporal": "restir",
    "restir.spatial0": "restir", "restir.shade": "restir", "post": None,
    "post.accumulate": "post", "post.svgf.surface": "post", "post.exposure": "post",
    "post.taa": "post", "post.fxaa": "post",
}


@pytest.fixture
def tracer():
    """A fresh tracer installed for the test (off unless enabled)."""
    p = profiler.Profiler()
    prev = profiler.install(p)
    try:
        yield p
    finally:
        profiler.install(prev)


@pytest.fixture(scope="module")
def court():
    bundle = outdoor_court(0.002, device="cpu")
    accel = build_accel(bundle.scene, bundle.atlas, device="cpu")
    return bundle, accel, scene_features(bundle.scene, bundle.uniforms, bundle.atlas)


def _setup(court, integ):
    bundle, accel, feats = court
    if integ == "mcpg":
        icfg = MCPGConfig(**SMALL, volume=VolumeConfig())
        cfg = RenderConfig(width=40, height=24, spp=2, max_path_length=3, features=feats,
                           integrator="mcpg")
    else:
        icfg = ReSTIRConfig()
        cfg = RenderConfig(width=40, height=24, spp=1, max_path_length=3, features=feats,
                           integrator="restir", denoise=True)
    return bundle, accel, cfg, icfg


def _frames(court, integ, n=2):
    bundle, accel, cfg, icfg = _setup(court, integ)
    cf = compile_frame(accel, bundle.atlas, cfg, init_state(cfg, icfg, device="cpu"), icfg)
    out = None
    for i in range(n):
        _, out = cf(bundle.uniforms._replace(frame=i))
    return tree_leaves((cf.state, {k: v for k, v in out.items() if k != "gbuffer"}))


def test_off_records_nothing(court, tracer, monkeypatch):
    made = []
    real = profiler._event
    monkeypatch.setattr(profiler, "_event", lambda dev: made.append(dev) or real(dev))
    bundle, accel, cfg, icfg = _setup(court, "mcpg")
    render_frame(accel, bundle.atlas, bundle.uniforms, cfg, init_state(cfg, icfg, device="cpu"),
                 icfg)
    assert made == []
    s = tracer.summary()
    assert s["frames"] == 0 and s["spans"] == {} and s["counters"] == {}
    assert tracer.records() == []


@pytest.mark.parametrize("integ", ["mcpg", "restir"])
def test_spans_under_the_profiler(court, tracer, integ):
    plain = _frames(court, integ)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = _frames(court, integ)
    assert len(plain) == len(traced)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    want = MCPG_SPANS if integ == "mcpg" else RESTIR_SPANS
    recs = tracer.records()
    frames = sorted({r["frame"] for r in recs})
    assert len(frames) == 2
    s = tracer.summary()
    assert s["frames"] == 2
    for name, parent in want.items():
        assert s["spans"][name]["parent"] == parent, name
        assert s["spans"][name]["frames"] == 2, name
        assert {r["frame"] for r in recs if r["name"] == name} == set(frames), name
    for name, v in s["spans"].items():
        kids = sum(r["ms"] for r in recs if r["parent"] == name)
        assert v["self_ms"] == pytest.approx(v["ms"] - kids)
    for r in recs:
        assert r["start_s"] <= r["end_s"] and r["ms"] >= 0.0
        if r["parent"] is not None:
            up = [p for p in recs if p["name"] == r["parent"] and p["frame"] == r["frame"]]
            assert up and up[0]["start_s"] <= r["start_s"] and r["end_s"] <= up[0]["end_s"]
    ranges = {e.name for e in prof.events() if e.name.startswith("mq.")}
    assert {"mq." + n for n in want} <= ranges
    if integ == "mcpg":
        c = s["counters"]
        assert c["mcpg.lanes_run"] == 2 * 2 * 40 * 24 * 2
        assert 0 < c["mcpg.lanes_live"] <= c["mcpg.lanes_run"]
        assert c["mcpg.states"] == 2 * MCPGConfig(**SMALL).mc_total_size
        assert 0 < c["mcpg.states_weighted"] <= c["mcpg.states"]
        assert c["mcpg.update_rows_dropped"] == 0 < c["mcpg.update_rows_live"]


def test_lanes_live_is_live_in(court, tracer):
    from merian_quake_tpu_torch.render.gbuffer import render_gbuffer
    from merian_quake_tpu_torch.render.mcpg import init_mcpg_state
    from merian_quake_tpu_torch.render.mcpg.surface import render_mcpg_surface

    bundle, accel, cfg, icfg = _setup(court, "mcpg")
    gbuf = render_gbuffer(accel, bundle.atlas, bundle.uniforms, cfg)
    tracer.enabled = True
    res = render_mcpg_surface(accel, bundle.atlas, bundle.uniforms, cfg, icfg,
                              init_mcpg_state(icfg, device="cpu"), gbuf)
    c = tracer.summary()["counters"]
    assert c["mcpg.lanes_live"] == int(res.live_in.sum())
    assert c["mcpg.lanes_run"] == 2 * 40 * 24 * 2


def test_update_rows_dropped_is_the_live_rows_past_the_capacity(tracer):
    from merian_quake_tpu_torch.render.mcpg.surface import (
        LCQueue, SurfaceResult, UpdateQueue, ZeroQueue,
    )
    from merian_quake_tpu_torch.render.mcpg.updates import compact_queues

    mcfg = MCPGConfig(**{**SMALL, "update_queue_capacity": 1024})
    S, M = mcfg.mc_total_size, 4096
    g = torch.Generator().manual_seed(7)
    live = torch.rand(M, generator=g) < 0.4
    data = torch.zeros((M, 15), dtype=torch.int32)
    data[:, 14] = torch.where(live, torch.randint(0, S, (M,), generator=g), S).to(torch.int32)
    res = SurfaceResult(
        irradiance=torch.zeros((1, 1, 4)), updates=UpdateQueue(data=data),
        lc_samples=LCQueue(pos=torch.zeros((M, 3)), normal=torch.zeros((M, 3)),
                           irr=torch.zeros((M, 3)), mask=torch.zeros(M, dtype=torch.bool)),
        zeros=ZeroQueue(cell=torch.zeros(M, dtype=torch.int32),
                        mask=torch.zeros(M, dtype=torch.bool)),
    )
    gidx = torch.arange(M, dtype=torch.int32)
    tracer.enabled = True
    compact_queues(res, mcfg, gidx, gidx)
    n_live = int(live.sum())
    assert n_live > 1024
    c = tracer.summary()["counters"]
    assert c["mcpg.update_rows_live"] == n_live
    assert c["mcpg.update_rows_dropped"] == n_live - 1024


def test_live_frame_host_spans(tracer):
    from merian_quake_tpu_torch.accel.build import build_accel_live, refresh_dynamic
    from merian_quake_tpu_torch.game.mod import make_arena

    game = make_arena(device="cpu")
    game = game[0] if isinstance(game, tuple) else game
    la = build_accel_live(game.gs.static_bundle, dyn_cap=game.gs.dynamic_capacity, device="cpu")
    cfg = RenderConfig(width=16, height=8, spp=1, max_path_length=2, integrator="pt",
                       features=scene_features(game.gs.static_bundle.scene,
                                               game.gs.static_bundle.uniforms,
                                               game.gs.static_bundle.atlas))
    cf = compile_frame(la.accel, game.gs.static_bundle.atlas, cfg,
                       init_state(cfg, device="cpu"))
    tracer.enabled = True
    for i in range(2):
        dyn, u = game.step_dynamic(dt=1 / 30, forward=100.0, yaw=15.0 * i)
        refresh_dynamic(la, dyn)
        cf(u)
    recs = tracer.records()
    names = ("step.qc", "step.entities", "step.extract", "refresh.rows", "refresh.write",
             "gbuffer", "pt", "post")
    by_frame = {}
    for r in recs:
        by_frame.setdefault(r["frame"], []).append(r["name"])
    assert len(by_frame) == 2
    for seen in by_frame.values():
        assert seen[:5] == list(names[:5]) and set(names) <= set(seen)
    s = tracer.summary()
    assert all(s["spans"][n]["parent"] is None and s["spans"][n]["frames"] == 2 for n in names)
