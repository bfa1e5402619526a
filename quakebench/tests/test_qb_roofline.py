"""The trace kernels' work model against sizes worked out by hand."""
import pytest

from quakebench import roofline, spec

PX = 1920 * 1080


def test_traces_of_a_frame():
    mcpg = roofline.traces(spec.config("mcpg_default"), alpha=True)
    # primary, 2 bounce segments of 2 spp, 2 volume scatter traces
    assert mcpg == [(PX, True), (2 * PX, True), (2 * PX, True), (PX, True), (PX, True)]
    restir = roofline.traces(spec.config("restir_di"), alpha=False)
    # primary, one candidate trace, the shade-time visibility
    assert restir == [(PX, True), (PX, True), (PX, False)]
    # alpha-tested triangles add the alpha-only table's trace to a visibility
    assert roofline.traces(spec.config("restir_di"), alpha=True)[-2:] == [(PX, False), (PX, True)]


def test_trace_floor_by_hand():
    nbytes, flops = roofline.trace_floor(1000, True, 640, 10)
    assert nbytes == 1000 * (32 + 16) + 640 * 48 + 10 * 24
    assert flops == 1000 * 42
    nbytes, _ = roofline.trace_floor(1000, False, 640, 10)
    assert nbytes == 1000 * 33 + 640 * 48 + 240


def test_frame_floor_is_bytes_bound_here():
    cfg = spec.config("restir_di")
    t = roofline.frame_floor_s(cfg, False, 16640, 260)
    want = sum(max(b / 3.35e12, f / 67e12) for b, f in
               (roofline.trace_floor(n, near, 16640, 260)
                for n, near in roofline.traces(cfg, False)))
    assert t == pytest.approx(want)
    # bytes bound: 48 bytes a ray against 42 operations
    assert t == pytest.approx((2 * (PX * 48) + PX * 33 + 3 * (16640 * 48 + 260 * 24)) / 3.35e12)
