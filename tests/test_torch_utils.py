"""The port's host utilities (utils/metrics.py, image.py, profiler.py and
render/mcpg/dumps.py): twins of the metrics, image, profiler and dumps
cases of tests/test_utils.py, and each held against the JAX package's
on the same numpy inputs.

- metrics: the port's copy on numpy arrays and on tensors gives the JAX
  package's floats exactly (both are the same numpy arithmetic; read:
  equal). Mutant: ``relmse`` without its ``eps`` fails.
- image files: a PNG or PFM written by one package reads back bit for
  bit through the other's reader (read: equal).
- dumps: ``dump_mc`` / ``dump_lc`` of one guiding state, carried across
  by ``interop``, write the same JSON lines as the JAX package's, byte
  for byte, on a state whose ids and hashes use all 32 bits (read:
  equal). Mutant: the ids read as signed i32 fails.
- profiler: the port's tracer (tests/test_torch_trace.py holds it at the
  frame's stages): spans and counters of two frames, their parents, its
  report; off, it records nothing. Its JAX twin's synchronizing spans are
  not carried over.
"""
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.render.mcpg import MCPGConfig as JMCPGConfig
from merian_quake_tpu.render.mcpg import init_mcpg_state as j_init_mcpg_state
from merian_quake_tpu.render.mcpg.dumps import dump_lc as j_dump_lc
from merian_quake_tpu.render.mcpg.dumps import dump_mc as j_dump_mc
from merian_quake_tpu.utils import image as j_image
from merian_quake_tpu.utils import metrics as j_metrics
from merian_quake_tpu_torch import interop
from merian_quake_tpu_torch.render.mcpg import MCPGConfig, init_mcpg_state
from merian_quake_tpu_torch.render.mcpg import dumps as t_dumps
from merian_quake_tpu_torch.utils import image as t_image
from merian_quake_tpu_torch.utils import metrics as t_metrics
from merian_quake_tpu_torch.utils.profiler import Profiler

torch.set_num_threads(min(2, torch.get_num_threads()))


def test_metrics_basics():
    ref = np.full((4, 4, 3), 2.0)
    img = ref + 0.5
    assert abs(t_metrics.rmse(img, ref) - 0.5) < 1e-6
    assert abs(t_metrics.mae(img, ref) - 0.5) < 1e-6
    assert t_metrics.relmse(ref, ref) == 0.0
    assert t_metrics.relmse(img, ref) > 0.0
    half = t_metrics.exposure_match(ref * 0.5, ref)
    np.testing.assert_allclose(half, ref)
    series = t_metrics.convergence_series([ref + 1.0, ref + 0.5, ref + 0.25], ref)
    assert series[0] > series[1] > series[2]
    np.testing.assert_allclose(t_metrics.combine_images([ref, ref + 1.0]), ref + 0.5)


def _metric_cases():
    r = np.random.default_rng(5)
    ref = r.gamma(1.0, 1.0, (12, 16, 3)).astype(np.float32)
    imgs = [ref + r.normal(0, s, ref.shape).astype(np.float32) for s in (0.5, 0.2, 0.1)]
    return ref, imgs


@pytest.mark.parametrize("as_tensor", [False, True])
def test_metrics_match_jax(as_tensor):
    ref, imgs = _metric_cases()
    wrap = (lambda x: torch.from_numpy(np.asarray(x))) if as_tensor else (lambda x: x)
    for name in ("rmse", "mae", "relmse", "relmse_trimmed"):
        for img in imgs:
            assert getattr(t_metrics, name)(wrap(img), wrap(ref)) == getattr(j_metrics, name)(img, ref)
    assert t_metrics.convergence_series([wrap(i) for i in imgs], wrap(ref)) == \
        j_metrics.convergence_series(imgs, ref)
    np.testing.assert_array_equal(t_metrics.combine_images([wrap(i) for i in imgs]),
                                  j_metrics.combine_images(imgs))
    np.testing.assert_array_equal(t_metrics.exposure_match(wrap(imgs[0]), wrap(ref)),
                                  j_metrics.exposure_match(imgs[0], ref))


def test_metrics_mutant_fails(monkeypatch):
    """relMSE without its eps: the bound (equality) catches it."""
    ref, imgs = _metric_cases()
    monkeypatch.setattr(t_metrics, "relmse", lambda img, ref, eps=1e-2: float(
        np.mean((np.asarray(img, np.float64) - ref) ** 2 / (np.asarray(ref, np.float64) ** 2))))
    assert t_metrics.relmse(imgs[0], ref) != j_metrics.relmse(imgs[0], ref)


def test_profiler_report():
    p = Profiler(enabled=True)
    for _ in range(2):
        with p.frame():
            with p.span("step"):
                pass
            with p.span("trace", torch.zeros(3)):
                with p.span("trace.inner"):
                    pass
            p.count("rays", torch.tensor(5))
            p.count("lanes", 3)
    s = p.summary()
    assert s["frames"] == 2 and s["counters"] == {"rays": 10, "lanes": 6}
    assert s["spans"]["trace.inner"]["parent"] == "trace"
    assert s["spans"]["step"]["count"] == s["spans"]["trace"]["frames"] == 2
    r = p.report()
    assert r.splitlines()[0] == "profiler report (2 frames; ms a frame):"
    assert "step" in r and "trace.inner" in r and "rays" in r
    p.reset()
    assert p.report().count("\n") == 0
    # off: nothing recorded, nothing read
    q = Profiler()
    with q.frame(), q.span("step"):
        q.count("rays", torch.tensor(1))
    assert q.summary()["frames"] == 0 and q.summary()["spans"] == {}


def test_image_roundtrip(tmp_path):
    img = (np.random.default_rng(0).uniform(0, 1, (16, 24, 3)) * 255).astype(np.uint8)
    p = str(tmp_path / "x.png")
    t_image.save_png(p, img)
    np.testing.assert_array_equal(t_image.load_png(p), img)
    hdr = np.random.default_rng(1).uniform(0, 10, (8, 12, 3)).astype(np.float32)
    pf = str(tmp_path / "x.pfm")
    t_image.save_pfm(pf, torch.from_numpy(hdr))
    np.testing.assert_allclose(t_image.load_pfm(pf), hdr, rtol=1e-6)


def test_image_files_cross_packages(tmp_path):
    r = np.random.default_rng(2)
    ldr = r.uniform(0, 1, (9, 13, 3)).astype(np.float32)
    rgba = (r.uniform(0, 1, (5, 7, 4)) * 255).astype(np.uint8)
    hdr = r.uniform(0, 100, (6, 10, 3)).astype(np.float32)
    for name, img in (("ldr", ldr), ("rgba", rgba)):
        a, b = str(tmp_path / f"{name}_t.png"), str(tmp_path / f"{name}_j.png")
        t_image.save_png(a, torch.from_numpy(img))
        j_image.save_png(b, img)
        assert open(a, "rb").read() == open(b, "rb").read()
        np.testing.assert_array_equal(t_image.load_png(b), j_image.load_png(a))
    a, b = str(tmp_path / "t.pfm"), str(tmp_path / "j.pfm")
    t_image.save_pfm(a, torch.from_numpy(hdr))
    j_image.save_pfm(b, hdr)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(t_image.load_pfm(b), j_image.load_pfm(a))


def test_mcpg_dumps(tmp_path):
    cfg = MCPGConfig(mc_adaptive_size=256, mc_static_size=64, lc_size=128)
    st = init_mcpg_state(cfg, device="cpu")
    st.mc.f[7, 3] = 3.0
    st.lc.N[5] = 2
    mc_path = str(tmp_path / "mc.json")
    lc_path = str(tmp_path / "lc.json")
    assert t_dumps.dump_mc(st, mc_path) == 1
    assert t_dumps.dump_lc(st, lc_path) == 1
    rows = [json.loads(line) for line in open(mc_path)]
    assert rows[0]["index"] == 7 and rows[0]["sum_w"] == 3.0
    meta = json.loads(open(lc_path).readline())["meta"]
    assert meta["active_cells"] == 1


def _random_state():
    """A JAX MCPGState with about half its chains and cells live, ids and
    hashes over all 32 bits (negative as i32)."""
    r = np.random.default_rng(9)
    cfg = JMCPGConfig(mc_adaptive_size=512, mc_static_size=64, lc_size=256)
    st = j_init_mcpg_state(cfg)
    s, l = st.mc.f.shape[0], st.lc.N.shape[0]
    f = r.normal(0, 2, (s, 9)).astype(np.float32)
    i = r.integers(-(1 << 31), 1 << 31, (s, 3), dtype=np.int64).astype(np.int32)
    return st._replace(
        mc=st.mc._replace(f=jnp.asarray(f), i=jnp.asarray(i)),
        lc=st.lc._replace(hash=jnp.asarray(r.integers(0, 1 << 32, l, dtype=np.int64).astype(np.uint32)),
                          irr=jnp.asarray(r.gamma(1, 1, (l, 3)).astype(np.float32)),
                          N=jnp.asarray(r.integers(-2, 3, l).astype(np.int32))),
        lc_updates_applied=jnp.asarray(123), lc_updates_merged=jnp.asarray(456),
    )


def _dumps(tmp_path, j_state, t_state):
    out = {}
    for kind in ("mc", "lc"):
        a, b = tmp_path / f"{kind}_j.json", tmp_path / f"{kind}_t.json"
        n_j = {"mc": j_dump_mc, "lc": j_dump_lc}[kind](j_state, str(a))
        n_t = getattr(t_dumps, f"dump_{kind}")(t_state, str(b))
        out[kind] = (n_j, n_t, a.read_bytes(), b.read_bytes())
    return out


def test_dumps_match_jax(tmp_path):
    j_state = _random_state()
    t_state = interop.mcpg_state_from_numpy(j_state, "cpu")
    for kind, (n_j, n_t, a, b) in _dumps(tmp_path, j_state, t_state).items():
        assert n_j == n_t > 50, kind
        assert a == b, kind


def test_dumps_mutant_fails(tmp_path, monkeypatch):
    """The chains' ids and hashes read as signed i32 (no u32 view): the
    lines differ."""
    j_state = _random_state()
    t_state = interop.mcpg_state_from_numpy(j_state, "cpu")
    signed = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np) if not k.startswith("__")})
    signed.uint32 = np.int32
    monkeypatch.setattr(t_dumps, "np", signed)
    (n_j, n_t, a, b) = _dumps(tmp_path, j_state, t_state)["mc"]
    assert n_j == n_t and a != b
