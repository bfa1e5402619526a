"""The profiler reduction: the port's own kernels against the glue,
busy time, idle gaps and their labels."""
import os

import pytest

from quakebench import devtrace, spec


def test_own_kernels_come_from_the_port_sources():
    own = devtrace.own_kernel_names(os.path.join(spec.ROOT, "merian_quake_tpu_torch", "csrc"))
    assert "woop_walk_kernel" in own and "mt_sweep_kernel" in own
    assert devtrace.is_own("void woop_walk_kernel<(Mode)2, true>(float const*, long)", own)
    assert devtrace.is_own("(anonymous namespace)::mt_sweep_kernel(float const*)", own)
    assert not devtrace.is_own("void at::native::vectorized_elementwise_kernel<4>(int)", own)
    assert not devtrace.is_own("Memcpy HtoD (Pinned -> Device)", own)


def test_summary_splits_busy_time_and_labels_gaps():
    own = frozenset({"k_own"})
    ops = [("k_own(int)", 0.0, 1.0), ("glue_a(int)", 1.0, 3.0), ("glue_a(int)", 5.0, 6.0),
           ("Memset (Device)", 6.0, 6.5), ("glue_b", 9.0, 9.5)]
    host = [("replay", 0.0, 0.2), ("step_dynamic", 3.0, 5.0)]
    s = devtrace.summarize(ops, host, (0.0, 10.0), own)
    assert s["busy_s"] == pytest.approx(5.0)
    assert s["own_s"] + s["glue_s"] == pytest.approx(s["busy_s"])
    assert (s["own_launches"], s["glue_launches"]) == (1, 4)
    assert s["idle_gaps"][0] == ["host", pytest.approx(2.5)]
    assert ["step_dynamic", pytest.approx(2.0)] in s["idle_gaps"]
    assert s["device_ops"][0] == ["glue_a(int)", pytest.approx(3.0)]


def test_union_and_gaps():
    assert devtrace.union([(0, 2), (1, 3), (5, 6)]) == 4
    assert devtrace.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
