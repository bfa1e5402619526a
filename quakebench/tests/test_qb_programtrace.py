"""The readers of the program's own spans and counters
(quakebench/programtrace.py): silent where nothing was recorded or the
program has no tracer, the right value from a hand-made ``summary()``,
and each reported in its cells only."""
import importlib

import pytest

from quakebench import scenes, spec

SPANS = {"replay_lead_ms": ("replay.lead",), "gbuffer_ms": ("gbuffer",),
         "mcpg_surface_ms": ("mcpg.pack", "mcpg.surface"), "mcpg_volume_ms": ("mcpg.volume",),
         "mcpg_update_ms": ("mcpg.update",), "restir_ms": ("restir",), "post_ms": ("post",),
         "carry_ms": ("carry",), "step_qc_ms": ("step.qc",), "refresh_rows_ms": ("refresh.rows",)}
SHARES = {"mcpg_live_lanes_pct": ("mcpg.lanes_live", "mcpg.lanes_run"),
          "mcpg_update_drop_pct": ("mcpg.update_rows_dropped", "mcpg.update_rows_live"),
          "mcpg_states_used_pct": ("mcpg.states_weighted", "mcpg.states")}
MCPG = {"mcpg_surface_ms", "mcpg_volume_ms", "mcpg_update_ms", *SHARES}
LIVE = {"step_qc_ms", "refresh_rows_ms"}


def _tracer():
    return importlib.import_module(f"{scenes.PROGRAM}.utils.profiler")


def _fake(frames=4):
    ms = {name: 10.0 * (i + 1) for i, name in enumerate(
        n for names in SPANS.values() for n in names)}
    return {"frames": frames, "replays": {"frames": frames, "ms": 1.0},
            "spans": {n: {"parent": None, "ms": v, "count": frames, "self_ms": v,
                          "frames": frames} for n, v in ms.items()},
            "counters": {"mcpg.lanes_live": 30.0, "mcpg.lanes_run": 120.0,
                         "mcpg.update_rows_dropped": 0.0, "mcpg.update_rows_live": 50.0,
                         "mcpg.states_weighted": 25.0, "mcpg.states": 200.0}}


def read(name):
    return spec.metric(name).read(None)


def test_silent_without_a_record(monkeypatch):
    tracer = _tracer()
    monkeypatch.setattr(tracer, "_ACTIVE", tracer.Profiler())
    for name in (*SPANS, *SHARES):
        assert read(name) is None, name
    # a program without the tracer's summary (an older checkout) reads None
    monkeypatch.delattr(tracer, "summary")
    for name in (*SPANS, *SHARES):
        assert read(name) is None, name


def test_values_from_a_summary(monkeypatch):
    fake = _fake()
    monkeypatch.setattr(_tracer(), "summary", lambda: fake)
    for name, spans in SPANS.items():
        want = sum(fake["spans"][n]["ms"] for n in spans) / 4
        assert read(name) == pytest.approx(want), name
    assert read("mcpg_live_lanes_pct") == pytest.approx(25.0)
    assert read("mcpg_update_drop_pct") == 0.0
    assert read("mcpg_states_used_pct") == pytest.approx(12.5)
    # a stage or counter the frame did not run reads None
    del fake["spans"]["mcpg.volume"], fake["counters"]["mcpg.lanes_run"]
    assert read("mcpg_volume_ms") is None and read("mcpg_live_lanes_pct") is None
    fake["frames"] = 0
    assert read("gbuffer_ms") is None


def test_each_metric_in_its_cells(bench):
    new = set(SPANS) | set(SHARES)
    by_cell = {c["name"]: {m["name"] for m in spec.cell_metrics(bench, c["name"], True)} & new
               for c in bench["workloads"]}
    for cell, names in by_cell.items():
        mcpg, live = cell.startswith("mcpg_default."), cell.endswith(".live_dungeon")
        assert bool(names & MCPG) == mcpg and (MCPG <= names) == mcpg, cell
        assert bool(names & LIVE) == live and (LIVE <= names) == live, cell
        assert ("restir_ms" in names) == cell.startswith("restir_di."), cell
    assert {c: len(n) for c, n in by_cell.items()} == {
        "restir_di.still_city": 5, "restir_di.live_dungeon": 7,
        "mcpg_default.still_map": 10, "mcpg_default.live_dungeon": 12}
    for m in bench["per_layer"]:
        if m["name"] in new:
            assert m["moves"] == "frame_ms"
            assert m["source"] == ("host_clock" if m["name"] in LIVE else "device_trace")
