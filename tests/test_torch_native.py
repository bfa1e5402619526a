"""The port's native accel builder (utils/native.py, built by the port from
native/mq_native.cc with native/Makefile's flags into ``_build/``) against
the numpy build and the JAX package's: twins of tests/test_native.py, and
``build_accel(native=..., cluster=...)`` against the JAX package's
``build_accel`` (with its ``MQ_CLUSTER=morton`` switch).

Bounds are those tests/test_native.py and tests/test_torch_accel.py
already use: Morton keys equal, cluster boxes within 1e-6 relative, Woop
rows within 1e-5 relative + 1e-7 (after the candidacy is baked in),
``build_accel``'s ``woop_w`` within 1e-6 of the JAX build's, its other
tables equal. Read on the CPU box: the native Woop rows equal the numpy
rows in value on the random soup, on city and on city(7000) (the
double-precision inverse rounds to the same f32; on the soup also built
with -ffp-contract=off, and without -march=native); bit for bit they
differ only in the sign of some zeros (the cofactor inverse's -0.0
against LAPACK's +0.0, both ways). The port's native build is the JAX
package's bit for bit.
"""
import os

import numpy as np
import pytest
import torch

from merian_quake_tpu.accel.build import build_accel as j_build_accel
from merian_quake_tpu.models.procedural import city as j_city
from merian_quake_tpu.models.procedural import cornell_box as j_cornell_box
from merian_quake_tpu_torch.accel import build as t_build
from merian_quake_tpu_torch.accel.woop import bake_candidacy, build_woop as woop_np
from merian_quake_tpu_torch.models.procedural import city, cornell_box
from merian_quake_tpu_torch.models.types import CLUSTER_SIZE, Scene
from merian_quake_tpu_torch.utils import native

torch.set_num_threads(min(2, torch.get_num_threads()))


@pytest.fixture(scope="module")
def lib():
    return native.load()


def _soup(rng, t=512):
    c = rng.uniform(-500, 500, (t, 1, 3))
    tri = c + rng.uniform(-30, 30, (t, 3, 3))
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    cand = rng.uniform(size=t) < 0.8
    valid = cand | (rng.uniform(size=t) < 0.5)
    return (v0.astype(np.float32), v1.astype(np.float32), v2.astype(np.float32), cand, valid)


def test_version_and_place(lib):
    assert lib.mq_version() == 1
    path = native.library_path()
    assert os.path.exists(path) and os.path.dirname(path) == native.BUILD_DIR
    assert native.CXXFLAGS[:2] == ("-O3", "-march=native")  # native/Makefile's


def test_morton_perm_matches_numpy(rng, lib):
    v0, v1, v2, cand, valid = _soup(rng)
    got = native.morton_perm(v0, v1, v2, cand, valid)
    ref = t_build._morton_perm(v0, v1, v2, cand, valid)
    cent = (v0 + v1 + v2) / 3.0
    lo = cent.min(0)
    q = np.clip((cent - lo) / np.maximum(cent.max(0) - lo, 1e-6) * 1023.0, 0, 1023)
    q = q.astype(np.uint64)
    key = (np.where(cand, 0, np.where(valid, 1, 2)).astype(np.uint64) << np.uint64(62)) | \
        t_build._morton3(q[:, 0], q[:, 1], q[:, 2])
    np.testing.assert_array_equal(key[got], key[ref])
    np.testing.assert_array_equal(got, ref)  # both stable: ties keep their index order
    assert (np.cumsum(~cand[got]) * cand[got]).sum() == 0


def test_cluster_aabbs_match(rng, lib):
    v0, v1, v2, cand, _ = _soup(rng, t=CLUSTER_SIZE * 4)
    lo, hi = native.cluster_aabbs(v0, v1, v2, cand, CLUSTER_SIZE)
    lo_p, hi_p = t_build.cluster_aabbs(v0, v1, v2, cand)
    np.testing.assert_allclose(lo, lo_p, rtol=1e-6)
    np.testing.assert_allclose(hi, hi_p, rtol=1e-6)
    cand[:CLUSTER_SIZE] = False  # an empty cluster
    lo, hi = native.cluster_aabbs(v0, v1, v2, cand, CLUSTER_SIZE)
    assert (lo[0] > 1e29).all() and (hi[0] < -1e29).all()


def test_woop_matches_numpy(rng, lib):
    v0, v1, v2, cand, _ = _soup(rng, t=CLUSTER_SIZE * 2)
    v2[3] = v0[3]  # a degenerate triangle: not a candidate on either route
    w_n, cand_n = native.build_woop(v0, v1, v2, cand, CLUSTER_SIZE)
    w_p, cand_p = woop_np(v0, v1, v2, cand)
    np.testing.assert_array_equal(cand_n, cand_p)
    assert not cand_n[3]
    np.testing.assert_allclose(bake_candidacy(w_n, cand_n), w_p, rtol=1e-5, atol=1e-7)


def _tables(acc):
    return {f: None if getattr(acc, f) is None else np.asarray(getattr(acc, f))
            for f in ("woop_w", "woop_w_shadow", "woop_w_alpha", "woop_w_proxy", "cluster_lo",
                      "cluster_hi", "cluster_lo_alpha", "cluster_hi_alpha", "cluster_lo_proxy",
                      "cluster_hi_proxy", "candidate", "needs_alpha", "tri_attr")}


def _hold(got, want):
    assert got.keys() == want.keys()
    for f, x in got.items():
        y = want[f]
        assert (x is None) == (y is None), f
        if x is None:
            continue
        if f.startswith("woop_w"):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("scene", ["cornell_box", "city"])
def test_build_accel_native_numpy_and_reference(scene, lib):
    tb = (cornell_box if scene == "cornell_box" else city)(device="cpu")
    jb = (j_cornell_box if scene == "cornell_box" else j_city)()
    acc_n = t_build.build_accel(tb.scene, tb.atlas, device="cpu")
    acc_p = t_build.build_accel(tb.scene, tb.atlas, device="cpu", native=False)
    _hold(_tables(acc_n), _tables(acc_p))
    _hold(_tables(acc_n), _tables(j_build_accel(jb.scene, jb.atlas)))
    for f in Scene._fields:  # the same triangle order
        np.testing.assert_array_equal(getattr(acc_n.scene, f).numpy(),
                                      getattr(acc_p.scene, f).numpy(), err_msg=f)


def test_morton_order_equals_reference(monkeypatch, lib):
    tb, jb = city(device="cpu"), j_city()
    acc_n = t_build.build_accel(tb.scene, tb.atlas, device="cpu", cluster="morton")
    acc_p = t_build.build_accel(tb.scene, tb.atlas, device="cpu", cluster="morton", native=False)
    monkeypatch.setenv("MQ_CLUSTER", "morton")
    acc_j = j_build_accel(jb.scene, jb.atlas)
    for f in Scene._fields:
        np.testing.assert_array_equal(getattr(acc_n.scene, f).numpy(),
                                      getattr(acc_p.scene, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(getattr(acc_n.scene, f).numpy(),
                                      np.asarray(getattr(acc_j.scene, f)), err_msg=f)
    _hold(_tables(acc_n), _tables(acc_j))
    median = t_build.build_accel(tb.scene, tb.atlas, device="cpu")
    assert not np.array_equal(median.scene.v0.numpy(), acc_n.scene.v0.numpy())
    with pytest.raises(ValueError):
        t_build.build_accel(tb.scene, cluster="hilbert", device="cpu")


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "mq_native.cc"
    bad.write_text("extern \"C\" int mq_version() { return }\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="building the accel builder failed"):
            native.load()
        monkeypatch.setattr(native.shutil, "which", lambda _: None)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            native.build_library()
        assert not list((tmp_path / "_build").glob("*.so"))
    finally:
        native.load.cache_clear()
