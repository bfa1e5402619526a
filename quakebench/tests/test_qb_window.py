"""The window's arithmetic and the metric readers on a hand-made record."""
import statistics

import pytest

from quakebench import run, spec


def _run(frames, **kw):
    base = dict(frames=frames, window_s=sum(frames), setup_s=12.5, mem_bytes=3 * 2**30,
                spans={}, build={"accel_build": [1.5], "capture": [4.0]}, profile=None,
                config=spec.config("restir_di"), alpha=True, n_tris=16640, n_clusters=260)
    base.update(kw)
    return run.Run(**base)


def read(name, r):
    return spec.metric(name).read(r)


def test_frame_ms_is_the_whole_window_over_the_frames():
    r = _run([0.1, 0.2, 0.3], window_s=0.75)  # 0.15 s between frames counts too
    assert read("frame_ms", r) == pytest.approx(250.0)


def test_p90_covers_every_frame():
    frames = [0.1] * 90 + [0.5] * 10
    want = statistics.quantiles([f * 1e3 for f in frames], n=10, method="inclusive")[8]
    assert read("frame_ms_p90", _run(frames)) == pytest.approx(want)
    # one slow frame in the last tenth moves it; the median would not
    assert read("frame_ms_p90", _run([0.1] * 10)) == pytest.approx(100.0)
    assert read("frame_ms_p90", _run([0.1] * 9 + [1.0])) > 100.0


def test_set_up_memory_and_spans():
    r = _run([0.1, 0.1], spans={"step_dynamic": [0.01, 0.03]})
    assert read("setup_s", r) == 12.5
    assert read("device_mem_gib", r) == pytest.approx(3.0)
    assert read("step_ms", r) == pytest.approx(20.0)
    assert read("refresh_ms", r) is None
    assert read("accel_build_s", r) == 1.5 and read("capture_s", r) == 4.0


def test_profile_readers_and_silence_without_a_trace():
    prof = {"busy_s": 0.9, "window_s": 1.0, "own_s": 0.1, "glue_s": 0.8,
            "own_launches": 8, "glue_launches": 4000}
    r = _run([0.5, 0.5], profile=prof)
    assert read("glue_ms", r) == pytest.approx(400.0)
    assert read("trace_ms", r) == pytest.approx(50.0)
    assert read("glue_launches", r) == 2000
    assert read("idle_pct", r) == pytest.approx(10.0)
    assert 0 < read("trace_roofline", r) < 100
    for name in ("glue_ms", "trace_ms", "trace_roofline", "idle_pct"):
        assert read(name, _run([0.5])) is None
    # no own kernel in the window: the roofline is silent, never 0
    assert read("trace_roofline", _run([0.5], profile=dict(prof, own_s=0.0))) is None
