"""SVGF denoiser: temporal integration + variance-guided à-trous filter.

Port of merian_quake_tpu/post/svgf.py (merian's SVGF node; Schied et
al. 2017): motion-vector reprojection with normal/depth validity gating,
temporally integrated first/second luminance moments, spatial variance
fallback for short histories, and N edge-aware à-trous wavelet
iterations with luminance/normal/depth stopping functions.

On CUDA tensors the temporal step and each à-trous pass are one launch
of a hand-written kernel (csrc/svgf.cu, wrappers ``svgf_temporal`` and
``svgf_atrous``), bit for bit the torch path on the card. On CPU tensors
the torch path runs: ``temporal_reference`` and
``atrous_iteration_reference``, the kernels' plain versions. There the
images a step reads at the same offsets are packed into one tensor and
gathered once (one bilinear reprojection of the whole history, one
edge-clamped gather a tap of irradiance, variance, luminance, normal and
depth). A gather moves values without arithmetic, so the packing is
exact; the arithmetic keeps the JAX package's order.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ..kernels import F, INT, P, check, entry, launch
from ..ops import color as color_ops
from .accumulate import reproject


class SVGFParams(NamedTuple):
    iterations: int = 5
    alpha_irr: float = 0.05
    alpha_moments: float = 0.2
    sigma_z: float = 1.0
    sigma_n: float = 128.0
    sigma_l: float = 10.0
    normal_reject_cos: float = 0.8
    depth_reject: float = 0.1  # relative depth difference gate


class SVGFState(NamedTuple):
    irr: torch.Tensor  # f32[H, W, 3] integrated irradiance
    moments: torch.Tensor  # f32[H, W, 2] integrated (l, l²)
    history_len: torch.Tensor  # f32[H, W]
    normal: torch.Tensor  # f32[H, W, 3] previous normals
    linear_z: torch.Tensor  # f32[H, W]


def init_svgf_state(height: int, width: int, device="cuda") -> SVGFState:
    z = lambda *s: torch.zeros((height, width) + s, device=device)
    return SVGFState(
        irr=z(3), moments=z(2), history_len=z(), normal=z(3),
        linear_z=torch.full((height, width), 1e30, device=device),
    )


@lru_cache(maxsize=512)
def _clamped(n: int, d: int, device) -> torch.Tensor:
    """arange(n) + d clamped to [0, n - 1] (one offset's gather indices)."""
    return torch.clamp(torch.arange(n, device=device) + d, 0, n - 1)


def _shift(img, dy: int, dx: int):
    """Shift with edge clamp (static offsets): out[y, x] = img[clamp(y +
    dy), clamp(x + dx)]."""
    H, W = img.shape[:2]
    dev = img.device
    return img[_clamped(H, dy, dev)[:, None], _clamped(W, dx, dev)]


def temporal(state: SVGFState, irr, moments_in, mv, normal, linear_z, z_grad,
             params: SVGFParams):
    """Temporal reprojection + moment integration.

    irr f32[H, W, 3] (this frame's noisy irradiance), moments_in f32[H, W]
    (its second moment), mv f32[H, W, 2]. Returns (new state, integrated
    irr, variance estimate). CUDA tensors launch ``svgf_temporal``.
    """
    if irr.is_cuda:
        new_state, rec, _ = svgf_temporal(state, irr, moments_in, mv, normal, linear_z, z_grad,
                                          params)
        return new_state, new_state.irr, rec[..., 3]
    return temporal_reference(state, irr, moments_in, mv, normal, linear_z, z_grad, params)


def temporal_reference(state: SVGFState, irr, moments_in, mv, normal, linear_z, z_grad,
                       params: SVGFParams):
    """The torch path of :func:`temporal` on any device: the plain
    version of ``svgf_temporal``."""
    lum = color_ops.yuv_luminance(irr)
    mom = torch.stack([lum, moments_in], dim=-1)

    # the five history images share one bilinear lookup
    packed = torch.cat([state.irr, state.moments, state.history_len[..., None], state.normal,
                        state.linear_z[..., None]], dim=-1)
    prev, valid_b = reproject(packed, mv)
    prev_irr, prev_mom, prev_hist = prev[..., 0:3], prev[..., 3:5], prev[..., 5]
    prev_n, prev_z = prev[..., 6:9], prev[..., 9]

    # reprojection validity (merian-shaders/reprojection.glsl semantics)
    n_ok = (prev_n * normal).sum(-1) > params.normal_reject_cos
    z_scale = z_grad.abs().sum(-1) + 1e-2
    z_ok = (prev_z - linear_z).abs() / (
        z_scale + linear_z.abs() * 1e-2 + 1e-4
    ) < params.depth_reject * 10.0
    valid = valid_b & n_ok & z_ok

    hist = torch.where(valid, prev_hist + 1.0, 1.0)
    a_i = torch.clamp_min(1.0 / hist, params.alpha_irr)[..., None]
    a_m = torch.clamp_min(1.0 / hist, params.alpha_moments)[..., None]
    int_irr = torch.where(valid[..., None], prev_irr + (irr - prev_irr) * a_i, irr)
    int_mom = torch.where(valid[..., None], prev_mom + (mom - prev_mom) * a_m, mom)

    var_t = torch.clamp_min(int_mom[..., 1] - torch.square(int_mom[..., 0]), 0.0)
    # spatial variance fallback for short history (3×3 luminance moments)
    l1 = torch.zeros_like(lum)
    l2 = torch.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            s = _shift(lum, dy, dx)
            l1 = l1 + s
            l2 = l2 + s * s
    var_s = torch.clamp_min(l2 / 9.0 - torch.square(l1 / 9.0), 0.0)
    variance = torch.where(hist < 4.0, torch.maximum(var_t, var_s), var_t)

    new_state = SVGFState(
        irr=int_irr, moments=int_mom, history_len=hist, normal=normal, linear_z=linear_z,
    )
    return new_state, int_irr, variance


_ATROUS_H = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)


def atrous_iteration(irr, variance, normal, linear_z, z_grad, step: int, params: SVGFParams):
    """One edge-aware à-trous wavelet iteration with 5×5 support. CUDA
    tensors launch ``svgf_atrous`` on the images packed as its records."""
    if irr.is_cuda:
        rec = svgf_atrous(torch.cat([irr, variance[..., None]], -1),
                          torch.cat([normal, linear_z[..., None]], -1), z_grad, step, params)
        return rec[..., :3], rec[..., 3]
    return atrous_iteration_reference(irr, variance, normal, linear_z, z_grad, step, params)


def atrous_iteration_reference(irr, variance, normal, linear_z, z_grad, step: int,
                               params: SVGFParams):
    """The torch path of :func:`atrous_iteration` on any device: the plain
    version of ``svgf_atrous``."""
    lum = color_ops.yuv_luminance(irr)
    # gaussian-prefiltered variance for the luminance weight
    gv = 0.0
    gw = 0.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            w = (0.25 if dy == 0 else 0.125) * (0.25 if dx == 0 else 0.125) * 4
            gv = gv + w * _shift(variance, dy, dx)
            gw = gw + w
    sigma_l_denom = params.sigma_l * torch.sqrt(torch.clamp_min(gv / gw, 0.0)) + 1e-8

    # every tap reads (irr, variance, luminance, normal, depth) at one offset
    packed = torch.cat([irr, variance[..., None], lum[..., None], normal, linear_z[..., None]],
                       dim=-1)
    acc_irr = torch.zeros_like(irr)
    acc_var = torch.zeros_like(variance)
    acc_w = torch.zeros_like(variance)
    z_scale = z_grad.abs().sum(-1) * step + 1e-2
    for iy, dy in enumerate((-2, -1, 0, 1, 2)):
        for ix, dx in enumerate((-2, -1, 0, 1, 2)):
            h = _ATROUS_H[iy] * _ATROUS_H[ix]
            q = _shift(packed, dy * step, dx * step)
            irr_q, var_q, lum_q = q[..., 0:3], q[..., 3], q[..., 4]
            n_q, z_q = q[..., 5:8], q[..., 8]
            w_n = torch.pow(torch.clamp_min((normal * n_q).sum(-1), 0.0), params.sigma_n)
            w_z = torch.exp(
                -(linear_z - z_q).abs()
                / (params.sigma_z * z_scale * (abs(dy) + abs(dx) + 1e-8) + 1e-8)
            )
            w_l = torch.exp(-(lum - lum_q).abs() / sigma_l_denom)
            w = h * w_n * w_z * w_l
            acc_irr = acc_irr + irr_q * w[..., None]
            acc_var = acc_var + var_q * w * w
            acc_w = acc_w + w
    out_irr = acc_irr / torch.clamp_min(acc_w, 1e-8)[..., None]
    out_var = acc_var / torch.clamp_min(acc_w * acc_w, 1e-8)
    return out_irr, out_var


def svgf_filter(irr, variance, normal, linear_z, z_grad, params: SVGFParams):
    """Run ``iterations`` à-trous passes with doubling step size."""
    for i in range(params.iterations):
        irr, variance = atrous_iteration(irr, variance, normal, linear_z, z_grad, 1 << i, params)
    return irr


def svgf(state: SVGFState, irr, moments_in, mv, normal, linear_z, z_grad, albedo,
         params: SVGFParams = SVGFParams()):
    """Full SVGF: temporal + spatial filter + albedo re-modulation.

    Returns (new_state, filtered beauty rgb). CUDA tensors launch the
    kernels: ``svgf_temporal``, then ``svgf_atrous`` a pass, the last one
    re-modulating (six launches at the default five iterations).
    """
    if irr.is_cuda:
        return svgf_kernels(state, irr, moments_in, mv, normal, linear_z, z_grad, albedo, params)
    new_state, int_irr, variance = temporal(
        state, irr, moments_in, mv, normal, linear_z, z_grad, params
    )
    filtered = svgf_filter(int_irr, variance, normal, linear_z, z_grad, params)
    # merian's SVGF re-modulates albedo internally
    return new_state, filtered * torch.clamp_min(albedo, 0.0)


# ---------------------------------------------------------------- the kernels (csrc/svgf.cu)

# (pointer, pixel stride) of 11 images, H, W, alpha_irr, alpha_moments,
# normal_reject_cos, depth_reject · 10, then out_irr, out_mom, out_len, rec,
# geo and the stream
_TEMPORAL_ARGS = (P, INT) * 11 + (INT, INT, F, F, F, F) + (P,) * 6
# rec, geo, z_grad, its stride, H, W, step, sigma_z, sigma_n, sigma_l, out,
# rgb, albedo, its stride, the stream
_ATROUS_ARGS = (P, P, P, INT, INT, INT, INT, F, F, F, P, P, P, INT, P)


def _pixels(name, x, shape, device) -> int:
    """The pixel stride, in floats, of image ``x``: f32 of ``shape`` ((H,
    W) or (H, W, C)) on ``device``, its pixels evenly spaced row after row
    and its channels adjacent (a contiguous image or a channel slice of
    one, such as ``irr[..., :3]`` or ``irr[..., 3]``). Raises otherwise."""
    check(name, x, torch.float32, shape, device, contiguous=False)
    st = x.stride()
    channels = shape[2] if len(shape) == 3 else 1
    if (channels > 1 and st[2] != 1) or st[1] < channels or st[0] != shape[1] * st[1]:
        raise ValueError(f"{name}: strides {st}: its pixels must lie evenly spaced row after "
                         "row with adjacent channels")
    return st[1]


def _record(name, x, hw, device):
    """Check a filter record: contiguous f32[H, W, 4], 16-byte aligned."""
    _pixels(name, x, hw + (4,), device)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def svgf_temporal(state: SVGFState, irr, moments_in, mv, normal, linear_z, z_grad,
                  params: SVGFParams = SVGFParams()):
    """The temporal step as the filter takes it: (new state, rec f32[H, W,
    4] (integrated irradiance, variance), geo f32[H, W, 4] (normal,
    linear_z)). Each image is f32 (H, W[, C]) as :func:`_pixels` takes it.
    On CUDA tensors this launches csrc/svgf.cu's temporal kernel, its
    outputs new (``torch.empty``) and nothing synchronized, and counts the
    launch in ``svgf_temporal.launches``; on CPU tensors it runs
    :func:`temporal_reference` and packs its outputs."""
    H, W = irr.shape[:2]
    dev = irr.device
    images = (("irr", irr, 3), ("moments_in", moments_in, 0), ("mv", mv, 2),
              ("normal", normal, 3), ("linear_z", linear_z, 0), ("z_grad", z_grad, 2),
              ("state.irr", state.irr, 3), ("state.moments", state.moments, 2),
              ("state.history_len", state.history_len, 0), ("state.normal", state.normal, 3),
              ("state.linear_z", state.linear_z, 0))
    strides = [_pixels(name, x, (H, W, c) if c else (H, W), dev) for name, x, c in images]
    if dev.type == "cpu":
        new_state, int_irr, variance = temporal_reference(
            state, irr, moments_in, mv, normal, linear_z, z_grad, params)
        return (new_state, torch.cat([int_irr, variance[..., None]], -1),
                torch.cat([normal, linear_z[..., None]], -1))
    empty = lambda *c: torch.empty((H, W) + c, device=dev)
    out_irr, out_mom, out_len, rec, geo = empty(3), empty(2), empty(), empty(4), empty(4)
    launch(entry("svgf", "mq_svgf_temporal", _TEMPORAL_ARGS), dev,
           *[v for (_, x, _), ps in zip(images, strides) for v in (x.data_ptr(), ps)], H, W,
           params.alpha_irr, params.alpha_moments, params.normal_reject_cos,
           params.depth_reject * 10.0, *[x.data_ptr() for x in (out_irr, out_mom, out_len, rec,
                                                                 geo)])
    svgf_temporal.launches += 1
    new_state = SVGFState(irr=out_irr, moments=out_mom, history_len=out_len, normal=normal,
                          linear_z=linear_z)
    return new_state, rec, geo


svgf_temporal.launches = 0


def svgf_atrous(rec, geo, z_grad, step: int, params: SVGFParams = SVGFParams(), albedo=None):
    """One à-trous pass of ``step`` on the records of :func:`svgf_temporal`:
    the next rec f32[H, W, 4]; with ``albedo`` (f32[H, W, 3], as
    :func:`_pixels` takes it) the pass is the last and returns rgb f32[H,
    W, 3] = filtered irradiance × max(albedo, 0). On CUDA tensors this
    launches csrc/svgf.cu's pass kernel and counts the launch in
    ``svgf_atrous.launches``; on CPU tensors it runs
    :func:`atrous_iteration_reference`."""
    H, W = rec.shape[:2]
    dev = rec.device
    _record("rec", rec, (H, W), dev)
    _record("geo", geo, (H, W), dev)
    zg_ps = _pixels("z_grad", z_grad, (H, W, 2), dev)
    alb_ps = 0 if albedo is None else _pixels("albedo", albedo, (H, W, 3), dev)
    if step < 1:
        raise ValueError(f"step {step}: must be at least 1")
    if dev.type == "cpu":
        irr, var = atrous_iteration_reference(rec[..., :3], rec[..., 3], geo[..., :3],
                                              geo[..., 3], z_grad, step, params)
        if albedo is None:
            return torch.cat([irr, var[..., None]], -1)
        return irr * torch.clamp_min(albedo, 0.0)
    out = torch.empty((H, W, 4 if albedo is None else 3), device=dev)
    rgb = None if albedo is None else out.data_ptr()
    launch(entry("svgf", "mq_svgf_atrous", _ATROUS_ARGS), dev, rec.data_ptr(),
           geo.data_ptr(), z_grad.data_ptr(), zg_ps, H, W, step, params.sigma_z, params.sigma_n,
           params.sigma_l, None if rgb else out.data_ptr(), rgb,
           None if albedo is None else albedo.data_ptr(), alb_ps)
    svgf_atrous.launches += 1
    return out


svgf_atrous.launches = 0


def svgf_kernels(state: SVGFState, irr, moments_in, mv, normal, linear_z, z_grad, albedo,
                 params: SVGFParams = SVGFParams()):
    """:func:`svgf` through the kernels' wrappers: ``svgf_temporal``, then
    ``svgf_atrous`` with doubling steps, the last pass re-modulating. On
    CPU tensors the wrappers run their plain versions, which give the bits
    of :func:`svgf`'s torch path."""
    new_state, rec, geo = svgf_temporal(state, irr, moments_in, mv, normal, linear_z, z_grad,
                                        params)
    if params.iterations == 0:
        return new_state, new_state.irr * torch.clamp_min(albedo, 0.0)
    for i in range(params.iterations):
        last = i == params.iterations - 1
        rec = svgf_atrous(rec, geo, z_grad, 1 << i, params, albedo if last else None)
    return new_state, rec
