"""The SVGF kernels' dispatch, wrappers and plain versions, on the CPU.

``post.svgf`` runs the SVGF on CUDA tensors as hand-written kernels
(csrc/svgf.cu: ``svgf_temporal``, then ``svgf_atrous`` a pass) and on CPU
tensors as its torch path (``temporal_reference``,
``atrous_iteration_reference``: the kernels' plain versions). Here:

- CPU tensors run the torch path as it was: ``svgf``, ``temporal``,
  ``atrous_iteration`` (steps 1-16) and ``svgf_filter`` equal the frozen
  copy of the port's torch SVGF in ``quakebench/reference/post/svgf.py``
  bit for bit, on seeded inputs with normal and depth edges, motion
  vectors off-screen and non-finite, the irradiance and albedo as the
  renderer slices them (channel views of f32[H, W, 4]);
- the wrappers' CPU path (the records the kernels pass: ``svgf_temporal``
  then ``svgf_atrous`` a pass, ``svgf_kernels``) gives the same bits, and
  nothing on the CPU reaches the kernel library or counts a launch;
- the wrappers raise on what the kernels do not take: another dtype,
  shape or device, images whose pixels are not evenly spaced row after
  row, records not contiguous, a step below 1.

The kernels themselves need the card: the ``cuda`` test skips here and
names chip_smoke's phase 40, which holds them bit for bit against the
torch path there (1080p and 37x53 inputs, halo-padded row slabs, a
captured city ReSTIR frame with denoise).
"""
import numpy as np
import pytest
import torch

from merian_quake_tpu_torch.post import svgf as sv
from quakebench.reference.post import svgf as frozen

torch.set_num_threads(min(2, torch.get_num_threads()))

H, W = 29, 41
P = sv.SVGFParams()


def _inputs(seed, h=H, w=W):
    """One frame's SVGF inputs on a fixed geometry (a normal flip, two depth
    planes and a step) with seeded irradiance and motion vectors (a band
    off the left edge, a NaN and an inf pixel)."""
    g = np.random.default_rng(21)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    n = np.zeros((h, w, 3), np.float32)
    n[..., 2] = 1.0
    n[:, w // 2:] = [1.0, 0.0, 0.0]
    n += g.normal(0, 0.05, n.shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    z = np.where(xx < w // 3, 10.0 + 0.01 * yy, 40.0 + 0.02 * xx).astype(np.float32)
    z[h // 4: h // 4 + 3] += 25.0
    r = np.random.default_rng(seed)
    irr = r.gamma(1.0, 0.5, (h, w, 4)).astype(np.float32)
    mv = r.normal(0, 0.6, (h, w, 2)).astype(np.float32)
    mv[:, :3, 0] = -3e3
    mv[-1, -1] = np.nan
    mv[0, -1] = np.inf
    t = torch.from_numpy
    return {"irr": t(irr), "mv": t(mv), "normal": t(n), "linear_z": t(z),
            "z_grad": t(g.normal(0, 0.05, (h, w, 2)).astype(np.float32)),
            "albedo": t(g.uniform(-0.1, 1.0, (h, w, 4)).astype(np.float32))}


def _args(x):
    """svgf's arguments after the state, as the renderer passes them."""
    return (x["irr"][..., :3], x["irr"][..., 3], x["mv"], x["normal"], x["linear_z"],
            x["z_grad"], x["albedo"][..., :3])


def _same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _history(frames):
    """The SVGF state after ``frames`` frames of the torch path."""
    state = sv.init_svgf_state(H, W, device="cpu")
    for f in range(frames):
        state = sv.svgf(state, *_args(_inputs(f)), P)[0]
    return state


@pytest.mark.parametrize("frames", [0, 1, 4])
def test_cpu_svgf_is_the_frozen_torch_path(frames):
    """svgf on CPU tensors: the frozen torch copy's bits, from an empty
    history (every reprojection invalid) and from histories 1 and 4
    frames deep."""
    state = _history(frames)
    x = _args(_inputs(10 + frames))
    got_state, got = sv.svgf(state, *x, P)
    ref_state, ref = frozen.svgf(frozen.SVGFState(*state), *x, frozen.SVGFParams())
    _same(got, ref)
    for a, b in zip(got_state, ref_state):
        _same(a, b)


@pytest.mark.parametrize("step", [1, 2, 4, 8, 16])
def test_cpu_atrous_iteration_is_the_frozen_torch_path(step):
    """atrous_iteration on CPU tensors (step 16 reaching past both borders
    of a 29x41 image): the frozen copy's bits."""
    x = _inputs(3)
    args = (x["irr"][..., :3], x["irr"][..., 3], x["normal"], x["linear_z"], x["z_grad"], step)
    got = sv.atrous_iteration(*args, P)
    for a, b in zip(got, frozen.atrous_iteration(*args, frozen.SVGFParams())):
        _same(a, b)


def test_cpu_temporal_and_filter_are_the_frozen_torch_path():
    state = _history(2)
    x = _args(_inputs(5))[:-1]
    got = sv.temporal(state, *x, P)
    ref = frozen.temporal(frozen.SVGFState(*state), *x, frozen.SVGFParams())
    for a, b in zip((*got[0], *got[1:]), (*ref[0], *ref[1:])):
        _same(a, b)
    f_args = (got[1], got[2], x[3], x[4], x[5])
    _same(sv.svgf_filter(*f_args, P), frozen.svgf_filter(*f_args, frozen.SVGFParams()))


@pytest.mark.parametrize("frames", [0, 3])
def test_cpu_wrappers_give_the_torch_path(frames, monkeypatch):
    """The kernels' wrappers on CPU tensors: their records carry the torch
    path's values, svgf_kernels gives svgf's bits, and nothing reaches the
    kernel library or counts a launch."""
    def no_library(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(sv, "entry", no_library)
    launches = (sv.svgf_temporal.launches, sv.svgf_atrous.launches)
    state = _history(frames)
    x = _args(_inputs(20 + frames))
    st_k, out_k = sv.svgf_kernels(state, *x, P)
    st_t, out_t = sv.svgf(state, *x, P)
    _same(out_k, out_t)
    for a, b in zip(st_k, st_t):
        _same(a, b)
    new_state, rec, geo = sv.svgf_temporal(state, *x[:-1], P)
    _, irr, var = sv.temporal_reference(state, *x[:-1], P)
    _same(rec[..., :3], irr)
    _same(rec[..., 3], var)
    _same(geo[..., :3], x[3])
    _same(geo[..., 3], x[4])
    nxt = sv.svgf_atrous(rec, geo, x[5], 2, P)
    for a, b in zip((nxt[..., :3], nxt[..., 3]),
                    sv.atrous_iteration_reference(irr, var, x[3], x[4], x[5], 2, P)):
        _same(a, b)
    assert (sv.svgf_temporal.launches, sv.svgf_atrous.launches) == launches


def test_cpu_wrappers_take_channel_slices():
    """The renderer's irradiance, moment and albedo are channel views of
    f32[H, W, 4]: a pixel stride of 4 floats."""
    x = _inputs(1)
    dev = torch.device("cpu")
    assert sv._pixels("irr", x["irr"][..., :3], (H, W, 3), dev) == 4
    assert sv._pixels("moments_in", x["irr"][..., 3], (H, W), dev) == 4
    assert sv._pixels("mv", x["mv"], (H, W, 2), dev) == 2
    rows = x["z_grad"][5:9]  # a row slab of a contiguous image (svgf_sharded's halo slices)
    assert sv._pixels("z_grad", rows, (4, W, 2), dev) == 2


def _bad_temporal(case):
    state = _history(1)
    x = list(_args(_inputs(2))[:-1])
    if case == "irr float64":
        x[0] = x[0].double()
    elif case == "mv with 3 channels":
        x[2] = torch.zeros((H, W, 3))
    elif case == "normal one row short":
        x[3] = x[3][1:]
    elif case == "linear_z transposed":
        x[4] = x[4].t().contiguous().t()
    elif case == "normal channels not adjacent":
        x[3] = x[3].permute(2, 0, 1).contiguous().permute(1, 2, 0)
    elif case == "state.irr rows with a gap":
        state = state._replace(irr=torch.zeros((H, W + 1, 3))[:, :W])
    elif case == "history_len int64":
        state = state._replace(history_len=state.history_len.long())
    return lambda: sv.svgf_temporal(state, *x, P)


def _bad_atrous(case):
    x = _inputs(2)
    rec = torch.cat([x["irr"][..., :3], x["irr"][..., 3:]], -1)
    geo = torch.cat([x["normal"], x["linear_z"][..., None]], -1)
    zg, alb, step = x["z_grad"], None, 1
    if case == "rec not contiguous":
        rec = torch.zeros((H, W, 8))[..., :4]
    elif case == "geo 3 channels":
        geo = geo[..., :3].contiguous()
    elif case == "z_grad float64":
        zg = zg.double()
    elif case == "albedo 4 channels":
        alb = x["albedo"]
    elif case == "albedo another size":
        alb = torch.zeros((H, W + 1, 3))
    elif case == "step 0":
        step = 0
    return lambda: sv.svgf_atrous(rec, geo, zg, step, P, albedo=alb)


@pytest.mark.parametrize("case", [
    "irr float64", "mv with 3 channels", "normal one row short", "linear_z transposed",
    "normal channels not adjacent", "state.irr rows with a gap", "history_len int64"])
def test_svgf_temporal_refuses(case):
    with pytest.raises(ValueError):
        _bad_temporal(case)()


@pytest.mark.parametrize("case", [
    "rec not contiguous", "geo 3 channels", "z_grad float64", "albedo 4 channels",
    "albedo another size", "step 0"])
def test_svgf_atrous_refuses(case):
    with pytest.raises(ValueError):
        _bad_atrous(case)()


@pytest.mark.cuda
def test_svgf_kernels_match_torch_path_on_card():
    """The kernels against svgf's torch path on the card, bit for bit: five
    frames of seeded 1080p inputs (the first with every history invalid,
    motion vectors off-screen and non-finite, normal and depth edges; every
    state leaf, the temporal records and each pass's), the same at 37x53
    (step 16 past both borders) and halo-padded row slabs as svgf_sharded
    passes them (chip_smoke phase 40 makes these comparisons, and holds
    a captured city ReSTIR frame with denoise against eager frames with the
    torch SVGF)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from chip_smoke.svgf import svgf_random, svgf_slab

    dev = torch.device("cuda")
    worst = {**svgf_random(dev, 1080, 1920, "")[0], **svgf_random(dev, 37, 53, "")[0]}
    for rows, y0, step in ((64, 0, 1), (64, 1016, 16), (40, 520, 16)):
        worst |= svgf_slab(dev, 1080, 1920, rows, y0, step, "")
    assert not {k: v for k, v in worst.items() if v[0]}
