"""Configurations, traffic mixes and metrics are found by name."""
import json
import os

import pytest

from quakebench import roofline, scenes, spec


def test_every_cell_finds_its_files(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for cell in bench["workloads"]:
        assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
        cfg = spec.config(cell["config"])
        assert cfg["render"]["width"] == 1920 and cfg["render"]["height"] == 1080
        assert configs[cell["config"]]["file"] == f"quakebench/configs/{cell['config']}.json"
        mix = spec.traffic(cell["traffic"])
        assert callable(scenes.resolve(scenes.PROGRAM, mix["scene"]["make"]))
        drv = spec.driver(mix["driver"])
        assert hasattr(drv, "Program") and hasattr(drv, "Reference")
        assert roofline.traces(cfg, alpha=False)[0] == (1920 * 1080, True)


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric(m["name"]).read)


def test_unknown_and_malformed_names_raise(bench):
    with pytest.raises(KeyError):
        spec.cell(bench, "nope.none")
    with pytest.raises(FileNotFoundError):
        spec.config("no_such_config")
    for bad in ("../BENCHMARK", "a/b", "", "x y"):
        with pytest.raises(ValueError):
            spec.traffic(bad)
        with pytest.raises(ValueError):
            spec.driver(bad)
    with pytest.raises(ModuleNotFoundError):
        spec.driver("no_such_driver")
    with pytest.raises(ValueError, match="tracemodels/no_such.py"):
        roofline.traces({"render": {"width": 4, "height": 2, "integrator": "no_such"}}, False)


def test_cell_metrics_follow_workloads_keys(bench):
    live = "mcpg_default.live_dungeon"
    still = "mcpg_default.still_map"
    names = lambda c, t: {m["name"] for m in spec.cell_metrics(bench, c, t)}
    assert {"step_ms", "refresh_ms"} <= names(live, True)
    assert not {"step_ms", "refresh_ms"} & names(still, True)
    assert names(still, False) == {"frame_ms", "frame_ms_p90", "device_mem_gib", "setup_s"}


def test_a_new_cell_needs_only_new_files_and_entries(bench, tmp_path):
    """A cell added by data: a new traffic file and a new entry, read by
    the same harness."""
    extra = dict(bench)
    extra["workloads"] = bench["workloads"] + [
        {"name": "restir_di.still_map", "config": "restir_di", "traffic": "still_map",
         "chips": 1, "why": "x"}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(extra))
    b = spec.load_benchmark(str(path))
    cell = spec.cell(b, "restir_di.still_map")
    assert spec.traffic(cell["traffic"])["scene"]["args"]["n_buildings"] == 28000
    assert os.path.exists(os.path.join(spec.HERE, "metrics", "frame_ms.py"))


def test_new_kinds_are_new_files(tmp_path, monkeypatch):
    """A world mover and a trace model that a later cell brings are found by
    name from files of their own, with no file of the harness edited."""
    import sys

    pkg = tmp_path / "quakebench"
    for sub in ("drivers", "tracemodels"):
        (pkg / sub).mkdir(parents=True)
    (pkg / "drivers" / "orbit_test.py").write_text(
        "class Program:\n    pass\n\n\nclass Reference:\n    pass\n")
    (pkg / "tracemodels" / "pt_test.py").write_text(
        "def traces(cfg, px, alpha):\n    return [(px, True)] * 2\n")
    import quakebench.drivers
    import quakebench.tracemodels

    monkeypatch.setattr(quakebench.drivers, "__path__",
                        [*quakebench.drivers.__path__, str(pkg / "drivers")])
    monkeypatch.setattr(quakebench.tracemodels, "__path__",
                        [*quakebench.tracemodels.__path__, str(pkg / "tracemodels")])
    try:
        assert hasattr(spec.driver("orbit_test"), "Program")
        cfg = {"render": {"width": 4, "height": 2, "integrator": "pt_test"}}
        assert roofline.traces(cfg, False) == [(8, True)] * 3
    finally:
        sys.modules.pop("quakebench.drivers.orbit_test", None)
        sys.modules.pop("quakebench.tracemodels.pt_test", None)
