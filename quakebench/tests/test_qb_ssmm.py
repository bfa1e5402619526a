"""The SSMM configuration and the two cells of ``ssmm_ad`` and
``restir_di.still_map``: the ``ssmm`` trace model, the four ``ssmm_*``
metrics read from a hand-made ``summary()``, each reported in its cell
only, the metrics of the live host and of ReSTIR in the new cell that runs
them, and both cells run whole on the CPU at a small size, traced: a
sound run is ``correct``, the control (the reference in bfloat16) fails,
and each cell's line carries its metrics."""
import importlib

import pytest

from quakebench import check, roofline, run, scenes, spec

from .conftest import small

PX = 1920 * 1080
SSMM = {"ssmm_ms", "ssmm_exchange_ms", "ssmm_chains_valid_pct", "ssmm_guided_pct"}
LIVE = {"step_ms", "refresh_ms", "step_qc_ms", "refresh_rows_ms"}


def test_ssmm_traces_one_bounce_a_sample():
    cfg = spec.config("ssmm_ad")
    # the gbuffer's primary trace, then one bounce of every pixel a sample
    for alpha in (False, True):
        assert roofline.traces(cfg, alpha) == [(PX, True), (PX, True)]
    two = scenes.merge(cfg, {"render": {"spp": 2}})
    assert roofline.traces(two, True) == [(PX, True), (2 * PX, True)]
    t = roofline.frame_floor_s(cfg, True, 313344, 4896)
    assert t == pytest.approx(2 * (PX * 48 + 313344 * 48 + 4896 * 24) / 3.35e12)


def _fake(frames=2):
    spans = {"ssmm": 80.0, "ssmm.inputs": 6.0, "ssmm.exchange": 30.0, "ssmm.sample": 14.0,
             "ssmm.trace": 22.0, "ssmm.chain": 4.0, "ssmm.smis": 4.0}
    return {"frames": frames, "replays": {"frames": frames, "ms": 1.0},
            "spans": {n: {"parent": None if n == "ssmm" else "ssmm", "ms": v, "count": frames,
                          "self_ms": v, "frames": frames} for n, v in spans.items()},
            "counters": {"ssmm.pixels_live": 400.0, "ssmm.chains_valid": 300.0,
                         "ssmm.guided": 250.0}}


def _tracer():
    return importlib.import_module(f"{scenes.PROGRAM}.utils.profiler")


def read(name):
    return spec.metric(name).read(None)


def test_metrics_from_a_summary(monkeypatch):
    fake = _fake()
    monkeypatch.setattr(_tracer(), "summary", lambda: fake)
    assert read("ssmm_ms") == pytest.approx(40.0)
    assert read("ssmm_exchange_ms") == pytest.approx(15.0)
    assert read("ssmm_chains_valid_pct") == pytest.approx(75.0)
    assert read("ssmm_guided_pct") == pytest.approx(62.5)
    # a program that counted no live pixel, or recorded no SSMM frame
    del fake["counters"]["ssmm.pixels_live"], fake["spans"]["ssmm.exchange"]
    assert read("ssmm_chains_valid_pct") is None and read("ssmm_guided_pct") is None
    assert read("ssmm_exchange_ms") is None


def test_metrics_silent_without_a_record(monkeypatch):
    tracer = _tracer()
    monkeypatch.setattr(tracer, "_ACTIVE", tracer.Profiler())
    for name in SSMM:
        assert read(name) is None, name
    monkeypatch.delattr(tracer, "summary")
    for name in SSMM:
        assert read(name) is None, name


def test_ssmm_metrics_in_the_ssmm_cell_only(bench):
    for c in bench["workloads"]:
        names = {m["name"] for m in spec.cell_metrics(bench, c["name"], True)} & SSMM
        assert names == (SSMM if c["config"] == "ssmm_ad" else set()), c["name"]
    for m in bench["per_layer"]:
        if m["name"] in SSMM:
            assert (m["layer"], m["moves"], m["source"]) == ("ssmm guiding", "frame_ms",
                                                             "device_trace")


def test_new_cells_carry_the_layers_they_run(bench):
    mcpg = {m["name"] for m in bench["per_layer"] if m["layer"] == "mcpg guiding"}
    got = {c: {m["name"] for m in spec.cell_metrics(bench, c, True)}
           for c in ("ssmm_ad.live_dungeon", "restir_di.still_map")}
    assert LIVE <= got["ssmm_ad.live_dungeon"] and not LIVE & got["restir_di.still_map"]
    assert "restir_ms" in got["restir_di.still_map"]
    assert "restir_ms" not in got["ssmm_ad.live_dungeon"]
    assert not mcpg & (got["ssmm_ad.live_dungeon"] | got["restir_di.still_map"])


@pytest.mark.parametrize("cell", ["ssmm_ad.live_dungeon", "restir_di.still_map"])
def test_new_cell_runs_correct_and_the_control_fails(bench, cell):
    out = run.run_cell(bench, cell, 4000000019, 0.2, True, device="cpu", overrides=small(cell),
                       control=True)
    assert out["correct"], out["check"]
    assert any(v > check.LIMITS[k] for k, v in out["control"].items()), out["control"]
    if cell.startswith("ssmm_ad."):
        assert out["check"]["tables"]["value"] == 0.0
        assert SSMM | LIVE <= set(out["metrics"]), sorted(out["metrics"])
        ms = out["metrics"]
        assert 0.0 < ms["ssmm_exchange_ms"]["value"] < ms["ssmm_ms"]["value"]
        assert 0.0 <= ms["ssmm_guided_pct"]["value"] <= ms["ssmm_chains_valid_pct"]["value"] <= 100.0
    else:
        assert not (SSMM | LIVE) & set(out["metrics"])
        assert "restir_ms" in out["metrics"]
