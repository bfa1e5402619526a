"""The compiled frame (renderer.compile_frame, graph.Graph.compile) and
what it rests on, on the CPU:

- (a) the alpha loop with its test on the device (``alpha_loop_on_device``:
  all ``max_intersections`` rounds, no host read) gives the same bits as
  the eager loop that stops after the last live ray, and agrees with the
  JAX ``trace_nearest`` within test_torch_accel.py's bounds, on the court's
  grates and on a soup of five stacked alpha grates (rays that pass every
  hole use all five rounds and end unhit). A dead ray is traced over an
  empty interval, so it does no triangle work: a mutant that advances
  ``cur_tmin`` past a dead ray's hit and traces it on fails that check.
- (b) ``frame_core`` with ``Uniforms.frame`` and ``FrameState.iteration``
  as device scalars gives the same bits as with Python ints: PT, ReSTIR,
  MCPG, MCPG + volume (the fogged court), SSMM, denoised PT and PT on the
  court, 64×32, 3 frames. (The slice tests hold the frames against the
  JAX package.)
- (c) ``accumulate`` with a tensor iteration against the JAX function for
  every iteration 0-100,000: the weight 1/(it + 1) is f32 on both sides,
  and equals the port's former Python-double weight rounded to f32.
- (d) no host read inside a compiled step: ``Tensor.__bool__``, ``item``,
  ``tolist``, ``numpy``, ``__int__``, ``__float__``, ``__index__`` and
  ``nonzero`` raise while a CompiledFrame step runs, for every case of (b)
  and for the compiled flagship graph on the fogged court; the mutant
  that puts the eager loop's ``bool(active.any())`` back fails.
- (e) ``compile_frame`` and ``Graph.compile`` on the CPU give the same
  bits as ``frame_core`` and ``Graph.run``; a frame on a device that is
  neither the CPU nor an available card is refused.
- The capture's helpers: the copy of the new state into the static
  state reads every value before it is overwritten, a call whose
  Python value differs from the capture's is refused, and
  ``CompiledFrame.set_state`` writes a state into the static one in
  place (certification's steady skip).
- (f) the captures themselves need the card: the ``cuda``-marked tests
  skip here and name chip_smoke.py's phase 38, which makes them there.
"""
import contextlib
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merian_quake_tpu.accel import build_accel as j_build_accel
from merian_quake_tpu.accel import trace_nearest as j_trace_nearest
from merian_quake_tpu.models import atlas as j_atlas
from merian_quake_tpu.models import materials
from merian_quake_tpu.models import procedural as j_procedural
from merian_quake_tpu_torch import capture, interop
from merian_quake_tpu_torch import renderer
from merian_quake_tpu_torch.accel import build_accel, trace_nearest
from merian_quake_tpu_torch.accel.build import scene_features
from merian_quake_tpu_torch.accel.intersect import alpha_loop_on_device
from merian_quake_tpu_torch.graph import Graph
from merian_quake_tpu_torch.graph.nodes import GraphContext, flagship_graph_config
from merian_quake_tpu_torch.models import procedural
from merian_quake_tpu_torch.models.types import RenderConfig, device_scalars
from merian_quake_tpu_torch.render.mcpg import MCPGConfig
from merian_quake_tpu_torch.render.mcpg.volume import VolumeConfig
from merian_quake_tpu_torch.renderer import compile_frame, frame_core, init_state
from test_torch_accel import _assert_hits_match

# the modules (the packages bind ``intersect`` and ``accumulate`` to functions)
intersect_mod = importlib.import_module("merian_quake_tpu_torch.accel.intersect")
t_accumulate = importlib.import_module("merian_quake_tpu_torch.post.accumulate")
j_accumulate = importlib.import_module("merian_quake_tpu.post.accumulate")

# The suite runs several test processes side by side on a few cores;
# torch would start one thread per core in each and oversubscribe them.
torch.set_num_threads(min(2, torch.get_num_threads()))

W, H, FRAMES = 64, 32, 3
FOG_MU_T = 0.002


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ (a) the alpha loop


def _court_rays():
    """test_torch_accel.py's grate rays: a column across both grates."""
    jb = j_procedural.outdoor_court()
    ys = np.linspace(110, 290, 64)
    o = np.asarray([[600.0, y, 80.0] for y in ys], np.float32)
    d = np.broadcast_to(np.asarray([1.0, 0.0, 0.0], np.float32), (64, 3)).copy()
    return jb, o, d


def _stack_rays():
    """Five stacked two-sided alpha grates in front of an opaque wall at
    x = 120. Grate k is a hole but for texel row and column k, and the
    last stops at z = 75: a ray is taken by the first grate whose cross
    it meets, by the wall after four rejections (above the last grate),
    or rejected five times and left unhit."""
    grates = []
    for k in range(5):
        tex = j_procedural._const_tex((120, 120, 120), size=8, alpha=0)
        tex[k, :, 3] = tex[:, k, 3] = 255
        grates.append(tex)
    b = j_procedural._SoupBuilder()
    Y, Z = 100.0, 100.0
    for k in range(5):
        x, z = 20.0 + 15.0 * k, 75.0 if k == 4 else Z
        b.quad((x, 0, 0), (0, Y, 0), (0, 0, z), texnum=2 + k)
        b.quad((x, 0, 0), (0, 0, z), (0, Y, 0), texnum=2 + k)
    b.quad((120.0, 0, 0), (0, 0, Z), (0, Y, 0), texnum=1)  # the wall, facing the rays
    atlas = j_atlas.pack_textures([j_procedural._const_tex((255, 255, 255), 1),
                                   j_procedural._const_tex((200, 200, 200))] + grates)
    jb = j_procedural.SceneBundle(b.build(), atlas, None)
    r = np.random.default_rng(5)
    yz = r.uniform(2.0, 98.0, (512, 2)).astype(np.float32)
    o = np.concatenate([np.zeros((512, 1), np.float32), yz], 1)
    d = np.broadcast_to(np.asarray([1.0, 0.0, 0.0], np.float32), (512, 3)).copy()
    return jb, o, d


def _alpha_case(make):
    jb, o, d = make()
    ja = j_build_accel(jb.scene, jb.atlas)
    atlas = interop.atlas_from_numpy(jb.atlas, device="cpu")
    ta = build_accel(interop.scene_from_numpy(jb.scene, device="cpu"), atlas)
    ref = j_trace_nearest(ja, jb.atlas, jnp.asarray(o), jnp.asarray(d), 0.0, materials.T_MAX)
    return ta, atlas, torch.from_numpy(o), torch.from_numpy(d), ref


def _traced(monkeypatch, ta, atlas, o, d, on_device):
    """trace_nearest eagerly or on the device, with every round's interval
    recorded. Returns (HitRecord, [(t_min, t_max) a round])."""
    rounds = []
    plain = intersect_mod.intersect

    def spy(accel, o_, d_, t_min, t_max, **kw):
        rounds.append((t_min.clone(), t_max.clone()))
        return plain(accel, o_, d_, t_min, t_max, **kw)

    with monkeypatch.context() as m:
        m.setattr(intersect_mod, "intersect", spy)
        with alpha_loop_on_device() if on_device else contextlib.nullcontext():
            hr = trace_nearest(ta, atlas, o, d, 0.0, materials.T_MAX)
    return hr, rounds


def _dead_rays_traced(rounds, masks):
    """Rays traced over a non-empty interval in a round though dead."""
    return sum(int(((t_max > t_min) & ~act).sum())
               for (t_min, t_max), act in zip(rounds, masks))


def _active_by_round(monkeypatch, ta, atlas, o, d):
    """Each round's live mask before it runs, read through the round."""
    masks = []
    plain = intersect_mod._alpha_round

    def spy(accel, tex, o_, d_, active, *a, **kw):
        masks.append(active.clone())
        return plain(accel, tex, o_, d_, active, *a, **kw)

    with monkeypatch.context() as m:
        m.setattr(intersect_mod, "_alpha_round", spy)
        with alpha_loop_on_device():
            trace_nearest(ta, atlas, o, d, 0.0, materials.T_MAX)
    return masks


@pytest.mark.parametrize("make", [_court_rays, _stack_rays], ids=["court", "stack"])
def test_alpha_loop_on_device_same_bits_as_host_loop(make, monkeypatch):
    ta, atlas, o, d, ref = _alpha_case(make)
    eager, eager_rounds = _traced(monkeypatch, ta, atlas, o, d, on_device=False)
    dev, dev_rounds = _traced(monkeypatch, ta, atlas, o, d, on_device=True)
    for a, b in zip(eager, dev):
        assert torch.equal(a, b)
    _assert_hits_match(dev, ref)
    assert len(dev_rounds) == materials.MAX_INTERSECTIONS
    assert len(eager_rounds) < len(dev_rounds) or make is _stack_rays
    # dead rays are traced over an empty interval: no triangle work
    masks = _active_by_round(monkeypatch, ta, atlas, o, d)
    assert _dead_rays_traced(dev_rounds, masks) == 0
    assert int((~masks[-1]).sum()) > 0  # some rays are dead in the last round
    if make is _stack_rays:
        # rays that pass every grate's hole use all five rounds and end unhit
        assert int(masks[-1].sum()) > 0 and len(eager_rounds) == materials.MAX_INTERSECTIONS
        t = _np(dev.t)
        assert (t > 1e30).any() and (np.abs(t - 120.0) < 1e-3).any()


def test_mutant_tracing_dead_rays_fails(monkeypatch):
    """A round that advances cur_tmin past a dead ray's hit and traces it on
    (its result still discarded): the same image, but dead rays do
    triangle work."""
    from merian_quake_tpu_torch.models import atlas as atlas_mod

    def mutant(accel, tex, o, d, active, cur_tmin, t_max, result, sort_rays=False,
               schedule=None):
        hr = intersect_mod.intersect(accel, o, d, cur_tmin, t_max)
        tri = torch.clamp_min(hr.tri, 0).long()
        needs = accel.needs_alpha[tri] & hr.hit
        uv = intersect_mod._hit_uv(accel, hr)
        a = atlas_mod.sample_nearest(tex, accel.scene.texnum[tri], uv)[..., 3]
        reject = needs & (a < materials.ALPHA_THRESHOLD)
        accept = active & ~reject
        result = intersect_mod.HitRecord(*[torch.where(accept, x, r) for x, r in zip(hr, result)])
        cur_tmin = torch.where(reject | ~active, hr.t + intersect_mod._ADVANCE, cur_tmin)
        return active & reject, cur_tmin, result

    ta, atlas, o, d, _ = _alpha_case(_stack_rays)
    good, _ = _traced(monkeypatch, ta, atlas, o, d, on_device=True)
    monkeypatch.setattr(intersect_mod, "_alpha_round", mutant)
    bad, rounds = _traced(monkeypatch, ta, atlas, o, d, on_device=True)
    for a, b in zip(good, bad):
        assert torch.equal(a, b)
    masks = _active_by_round(monkeypatch, ta, atlas, o, d)
    assert _dead_rays_traced(rounds, masks) > 0


# ------------------------------------------------------------ (b), (d), (e): frames


def _box():
    return procedural.cornell_box(device="cpu")


def _court():
    return procedural.outdoor_court(FOG_MU_T, device="cpu")


CASES = {
    "pt": (_box, RenderConfig(width=W, height=H, spp=1), None),
    "restir": (_box, RenderConfig(width=W, height=H, integrator="restir"), None),
    "mcpg": (_box, RenderConfig(width=W, height=H, integrator="mcpg"), MCPGConfig()),
    "mcpg_volume": (_court, RenderConfig(width=W, height=H, integrator="mcpg"),
                    MCPGConfig(volume=VolumeConfig())),
    "ssmm": (_box, RenderConfig(width=W, height=H, spp=2, integrator="ssmm"), None),
    "pt_denoise": (_box, RenderConfig(width=W, height=H, denoise=True), None),
    "pt_court": (_court, RenderConfig(width=W, height=H, spp=1), None),
}
_SCENES = {}


def _scene(name):
    make, config, icfg = CASES[name]
    if make not in _SCENES:
        bundle = make()
        _SCENES[make] = (bundle, build_accel(bundle.scene, bundle.atlas, device="cpu"))
    bundle, accel = _SCENES[make]
    config = config._replace(features=scene_features(bundle.scene, bundle.uniforms, bundle.atlas))
    return bundle, accel, config, icfg


READS = ("__bool__", "item", "tolist", "numpy", "__int__", "__float__", "__index__", "nonzero")


@contextlib.contextmanager
def no_host_reads():
    """Every way Python reads a tensor's values to the host raises."""
    def refuse(name):
        def read(*a, **k):
            raise AssertionError(f"host read inside a compiled step: Tensor.{name}")
        return read

    with pytest.MonkeyPatch.context() as m:
        for name in READS:
            m.setattr(torch.Tensor, name, refuse(name))
        m.setattr(torch, "nonzero", refuse("nonzero"))
        yield


def _compiled_run(name, guard=True):
    bundle, accel, config, icfg = _scene(name)
    step = compile_frame(accel, bundle.atlas, config, init_state(config, icfg, device="cpu"), icfg)
    for i in range(FRAMES):
        with no_host_reads() if guard else contextlib.nullcontext():
            state, out = step(bundle.uniforms._replace(frame=i))
    return state, out


_RUNS = {}


def _runs(name):
    """(int form, tensor form, compiled step) of case ``name``, 3 frames."""
    if name not in _RUNS:
        bundle, accel, config, icfg = _scene(name)
        forms = {}
        for form in ("int", "tensor"):
            state = init_state(config, icfg, device="cpu")
            if form == "int":
                state = state._replace(iteration=0)
            for i in range(FRAMES):
                u = bundle.uniforms._replace(frame=i)
                u = device_scalars(u) if form == "tensor" else u
                state, out = frame_core(accel, bundle.atlas, u, config, state, mcpg_config=icfg)
            forms[form] = (state, out)
        forms["compiled"] = _compiled_run(name)
        _RUNS[name] = forms
    return _RUNS[name]


def _assert_same_bits(a, b):
    la, lb = capture.tree_leaves(a), capture.tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_frame_and_iteration_same_bits_as_ints(name):
    runs = _runs(name)
    (i_state, i_out), (t_state, t_out) = runs["int"], runs["tensor"]
    assert i_state.iteration == FRAMES and isinstance(i_state.iteration, int)
    assert t_state.iteration.dtype == torch.int32 and int(t_state.iteration) == FRAMES
    _assert_same_bits(i_state._replace(iteration=None), t_state._replace(iteration=None))
    _assert_same_bits(i_out, t_out)
    assert float(t_out["ldr"].std()) > 0.0


@pytest.mark.parametrize("name", list(CASES))
def test_compiled_step_same_bits_as_frame_core_and_reads_nothing(name):
    """(d) and (e): the compiled step ran under the guard; its frames are
    frame_core's bit for bit (the alpha loop's rounds past the last live
    ray change nothing)."""
    runs = _runs(name)
    _assert_same_bits(runs["compiled"], runs["tensor"])


def test_mutant_host_read_in_the_alpha_loop_fails(monkeypatch):
    """The compiled step without the device-side loop test reads
    ``bool(active.any())`` on the court: the guard refuses it."""
    monkeypatch.setattr(renderer, "alpha_loop_on_device", contextlib.nullcontext)
    with pytest.raises(AssertionError, match="host read inside a compiled step: Tensor.__bool__"):
        _compiled_run("pt_court")


def test_compile_frame_needs_a_card_off_the_cpu():
    bundle, accel, config, _ = _scene("pt")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        compile_frame(accel, bundle.atlas, config, init_state(config, device="meta"))
    with pytest.raises((AssertionError, RuntimeError)):  # no card: the state cannot be made
        compile_frame(accel, bundle.atlas, config, init_state(config, device="cuda"))


def _flagship(frames, compiled):
    bundle, accel, config, _ = _scene("mcpg_volume")
    config = config._replace(width=48, height=32, denoise=True)
    mcfg = MCPGConfig(volume=VolumeConfig(volume_spp=1))
    g = Graph.from_config(flagship_graph_config(), GraphContext(
        accel, bundle.atlas, config, mcpg_config=mcfg, device="cpu"))
    step = g.compile() if compiled else g.run
    state = g.init_state()
    assert state["iteration"].dtype == torch.int32
    for i in range(frames):
        with no_host_reads() if compiled else contextlib.nullcontext():
            state, out = step(state, {"uniforms": bundle.uniforms._replace(frame=i)})
    return state, out


def test_compiled_flagship_graph_same_bits_as_run_and_reads_nothing():
    """The flagship graph (MCPG + volume + both SVGFs + TAA + FXAA + HUD) on
    the fogged court: Graph.compile's step under the guard equals run."""
    run_state, run_out = _flagship(2, compiled=False)
    st, out = _flagship(2, compiled=True)
    _assert_same_bits(st, run_state)
    _assert_same_bits(out, run_out)
    assert int(st["iteration"]) == 2 and int(st["nodes"]["volume_accum"]["iteration"]) == 2


# ------------------------------------------------------------ (c) accumulate


def test_accumulate_tensor_iteration_matches_jax():
    """Every iteration 0-100,000 at once (the weight broadcasts along the
    history): bit for bit against the JAX function, alpha 0 and 0.1, and
    the same weight as the port's former Python-double 1 / (it + 1)
    rounded to f32 (no ulp moved)."""
    n = 100_001
    r = np.random.default_rng(9)
    hist = r.uniform(-2, 2, n).astype(np.float32)
    new = r.uniform(-2, 2, n).astype(np.float32)
    it = np.arange(n, dtype=np.int32)
    for alpha in (0.0, 0.1):
        got = t_accumulate.accumulate(torch.from_numpy(hist), torch.from_numpy(new),
                                      torch.from_numpy(it), alpha=alpha).numpy()
        want = np.asarray(j_accumulate.accumulate(jnp.asarray(hist), jnp.asarray(new),
                                                  jnp.asarray(it), alpha=alpha))
        np.testing.assert_array_equal(got, want)
    ones, zeros = torch.ones(n), torch.zeros(n)
    weight = t_accumulate.accumulate(zeros, ones, torch.from_numpy(it)).numpy()
    np.testing.assert_array_equal(weight, (1.0 / (np.arange(n) + 1.0)).astype(np.float32))
    for k in (0, 1, 7, 99_999):  # a Python int and a 0-d tensor alike
        a = t_accumulate.accumulate(torch.from_numpy(hist), torch.from_numpy(new), k)
        b = t_accumulate.accumulate(torch.from_numpy(hist), torch.from_numpy(new),
                                    torch.tensor(k, dtype=torch.int32))
        assert torch.equal(a, b)


# ------------------------------------------------------------ the capture's helpers


def test_carry_reads_every_value_before_it_is_overwritten():
    """A new state that swaps two static tensors, and an output that is a
    static tensor the copies overwrite, keep the step's values."""
    a, b, c = torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0]), torch.tensor([5.0])
    static = {"a": a, "b": b, "c": c}
    new = {"a": b, "b": a, "c": c}  # swapped; c kept as it is
    out = capture._carry(static, new, {"old_a": a, "c": c})
    assert static["a"] is a and static["b"] is b
    assert a.tolist() == [3.0, 4.0] and b.tolist() == [1.0, 2.0] and c.tolist() == [5.0]
    assert out["old_a"].tolist() == [1.0, 2.0] and out["c"] is c


def test_assign_refuses_a_changed_python_value():
    static = {"x": torch.zeros(3), "n": torch.zeros((), dtype=torch.int64), "k": 4}
    capture.assign(static, {"x": torch.ones(3), "n": 7, "k": 4})
    assert static["x"].tolist() == [1.0] * 3 and int(static["n"]) == 7
    with pytest.raises(ValueError, match="must be a tensor"):
        capture.assign(static, {"x": torch.ones(3), "n": 7, "k": 5})
    with pytest.raises(ValueError, match="shape"):
        capture.assign(static, {"x": torch.ones(4), "n": 7, "k": 4})
    assert capture.skeleton({"x": torch.zeros(2), "k": 1}) != capture.skeleton({"x": torch.zeros(3), "k": 1})


def test_set_state_writes_the_static_state_in_place():
    """CompiledFrame.set_state before the capture replaces the state; after
    it (here a stand-in with the static state) it writes the given state
    into the static buffers: a restarted accumulator is zeroed in place,
    the tensors the static state holds are kept as they are, and another
    shape raises."""
    import types

    from merian_quake_tpu_torch.utils.certify import _restart_accumulation

    bundle, accel, config, icfg = _scene("mcpg")
    step = compile_frame(accel, bundle.atlas, config, init_state(config, icfg, device="cpu"), icfg)
    for i in range(2):
        step(bundle.uniforms._replace(frame=i))
    fresh = init_state(config, icfg, device="cpu")
    step.set_state(fresh)
    assert step.state is fresh
    for i in range(2):
        step(bundle.uniforms._replace(frame=i))
    static = step.state
    step.captured = types.SimpleNamespace(state=static)
    held = {id(x): x.data_ptr() for x in capture.tree_leaves(static)}
    mc_before = static.mcpg.mc.f.clone()
    step.set_state(_restart_accumulation(static))
    assert step.state is static and int(static.iteration) == 0
    assert float(static.accum_irradiance.abs().sum()) == 0.0
    assert {id(x): x.data_ptr() for x in capture.tree_leaves(static)} == held
    assert torch.equal(static.mcpg.mc.f, mc_before)
    with pytest.raises(ValueError, match="shape"):
        step.set_state(static._replace(accum_direct=torch.zeros(2, 2, 4)))


# ------------------------------------------------------------ (f) on the card


@pytest.mark.cuda
def test_captured_frames_equal_eager_on_the_card():
    """Each captured frame (city MCPG 1080p, the fogged court's MCPG +
    volume, city ReSTIR, denoised city MCPG, map MCPG) against eager
    frame_core from the same state, bit for bit over 8 replays, with K1,
    K2 and K3 launched inside the graphs. The card's machine has no JAX,
    so this file cannot run there: chip_smoke.py phase 38 makes these
    comparisons."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    bundle = procedural.cornell_box(device="cuda")
    config = RenderConfig(width=W, height=H, integrator="mcpg")
    accel = build_accel(bundle.scene, bundle.atlas)
    step = compile_frame(accel, bundle.atlas, config, init_state(config, MCPGConfig(), device="cuda"))
    for i in range(2):
        ref = capture.tree_map(torch.clone, step.state)
        ref_state, ref_out = frame_core(accel, bundle.atlas, bundle.uniforms._replace(frame=i),
                                        config, ref, mcpg_config=MCPGConfig())
        state, out = step(bundle.uniforms._replace(frame=i))
        _assert_same_bits(state, ref_state)
        _assert_same_bits(out, ref_out)


@pytest.mark.cuda
def test_captured_flagship_graph_equals_run_on_the_card():
    """The flagship graph's compile() against run on the card: chip_smoke.py
    phase 38."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    bundle = procedural.cornell_box(device="cuda")
    config = RenderConfig(width=W, height=H, integrator="mcpg", denoise=True)
    g = Graph.from_config(flagship_graph_config(), GraphContext(
        build_accel(bundle.scene, bundle.atlas), bundle.atlas, config, mcpg_config=MCPGConfig(),
        device="cuda"))
    step = g.compile()
    st = g.init_state()
    ref = capture.tree_map(torch.clone, st)
    ref, ref_out = g.run(ref, {"uniforms": bundle.uniforms})
    st, out = step(st, {"uniforms": bundle.uniforms})
    _assert_same_bits(st, ref)
