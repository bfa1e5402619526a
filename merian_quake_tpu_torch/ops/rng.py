"""Counter-based / stateful RNG streams (pcg4d seeding + xorshift32).

Port of merian_quake_tpu/ops/rng.py, bit-exact. u32 values are held in
int64 tensors in [0, 2^32). On CUDA tensors a pixel seed and a run of k
draws are one launch each of csrc/u32_chains.cu, in native u32. On CPU
tensors their plain versions run (``seed_pixel_reference``,
``uniforms_reference``): torch has no u32 shifts or adds on every
device, so each op is done in int64 and masked back to 32 bits, with
products split so that no intermediate leaves int64's signed range.
"""
from __future__ import annotations

import ctypes
import itertools

import torch

from ..kernels import I64, INT, P, check, entry, launch

_M32 = 0xFFFFFFFF
# 1/2^32 — maps u32 to [0, 1).
_INV_U32 = 2.3283064365386963e-10


def _u32(x, like: torch.Tensor) -> torch.Tensor:
    """u32 value(s) as int64 on ``like``'s device (a Python int becomes a
    device-side fill, not a stalling host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.int64) & _M32
    return torch.full((), int(x) & _M32, dtype=torch.int64, device=like.device)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for u32 values, without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x, y, z, w):
    x = (x + _mul32(y, w)) & _M32
    y = (y + _mul32(z, x)) & _M32
    z = (z + _mul32(x, y)) & _M32
    w = (w + _mul32(y, z)) & _M32
    return x, y, z, w


def pcg4d(v: torch.Tensor) -> torch.Tensor:
    """PCG4D hash (Jarzynski & Olano, JCGT 2020). ``v``: u32[..., 4]."""
    v = _u32(v, v)
    v = (_mul32(v, 1664525) + 1013904223) & _M32
    x, y, z, w = _mix(*v.unbind(-1))
    v = torch.stack([x, y, z, w], dim=-1)
    v = v ^ (v >> 16)
    x, y, z, w = _mix(*v.unbind(-1))
    return torch.stack([x, y, z, w], dim=-1)


def seed_pixel_reference(px: torch.Tensor, py: torch.Tensor, frame, seed) -> torch.Tensor:
    """The torch path of :func:`seed_pixel`: the plain version of
    csrc/u32_chains.cu's mq_seed_pixel."""
    parts = torch.broadcast_tensors(
        _u32(px, px), _u32(py, px), _u32(frame, px), _u32(seed, px)
    )
    h = pcg4d(torch.stack(parts, dim=-1))[..., 0]
    # Avoid the xorshift32 fixed point at 0.
    return torch.where(h == 0, 0x9E3779B9, h)


def xorshift32_raw(state: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step. Returns the new state (also the raw sample)."""
    state = _u32(state, state)
    state = state ^ ((state << 13) & _M32)
    state = state ^ (state >> 17)
    state = state ^ ((state << 5) & _M32)
    return state


def uniform_reference(state: torch.Tensor):
    """The torch path of :func:`uniform`."""
    state = xorshift32_raw(state)
    return state, state.to(torch.float32) * _INV_U32


def uniforms_reference(state: torch.Tensor, k: int):
    """The torch path of :func:`uniforms`: the plain version of
    csrc/u32_chains.cu's mq_uniforms."""
    us = []
    for _ in range(k):
        state, u = uniform_reference(state)
        us.append(u)
    return state, torch.stack(us, dim=-1)


# the C entry points' arguments: a seed operand (pointer or None, stride,
# value, int64 or not) four times, n, the output and the stream; the state,
# n, k, the two outputs and the stream
_OPERAND = (P, I64, ctypes.c_uint, INT)
_SEED_ARGS = _OPERAND * 4 + (I64, P, P)
_UNIFORMS_ARGS = (P, I64, INT, P, P, P)


def _broadcast(shapes) -> tuple:
    """The shape ``shapes`` broadcast to, by numpy's rule. Written out:
    torch.broadcast_shapes imports sympy at its first call, seconds of
    every process's first frame."""
    out = []
    for dims in itertools.zip_longest(*[s[::-1] for s in shapes], fillvalue=1):
        sizes = {d for d in dims if d != 1}
        if len(sizes) > 1:
            raise ValueError(f"seed_pixel: operands of shapes {shapes} do not broadcast")
        out.append(sizes.pop() if sizes else 1)
    return tuple(out[::-1])


def _operand(name: str, x, dev, shape):
    """One pcg4d input as mq_seed_pixel takes it: (pointer, stride, value,
    wide). A Python int or a one-element tensor off ``dev`` is a value
    (read on the host: no device read); a one-element tensor on ``dev`` is
    read for every lane at stride 0; any other tensor has the output's
    shape and a single stride over its lanes."""
    if not isinstance(x, torch.Tensor):
        return None, 0, int(x) & _M32, 0
    if x.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: expected int32 or int64, got {x.dtype}")
    if x.device != dev:
        if x.numel() != 1 or x.device.type != "cpu":
            raise ValueError(f"{name}: on {x.device}, expected {dev}")
        return None, 0, int(x.reshape(())) & _M32, 0
    wide = int(x.dtype == torch.int64)
    if x.numel() == 1:
        return x.data_ptr(), 0, 0, wide
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.dim() == 1:
        return x.data_ptr(), x.stride(0), 0, wide
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be 1-D or contiguous")
    return x.data_ptr(), 1, 0, wide


def seed_pixel(px: torch.Tensor, py, frame, seed) -> torch.Tensor:
    """Per-pixel stream seed: pcg4d16(pixel, frame, SEED) → u32 state.

    ``px`` is a tensor; ``py``, ``frame`` and ``seed`` are tensors or Python
    ints, broadcast against it. On CUDA tensors one launch of
    csrc/u32_chains.cu (int32 or int64 tensors, each of one element, of
    the output's shape at one stride over its lanes, or a one-element CPU
    tensor), counted in ``seed_pixel.launches``; on CPU tensors
    :func:`seed_pixel_reference`. Raises on another dtype, device or
    layout."""
    dev = px.device
    parts = {"px": px, "py": py, "frame": frame, "seed": seed}
    shape = _broadcast([tuple(x.shape) for x in parts.values() if isinstance(x, torch.Tensor)])
    ops = [_operand(k, x, dev, shape) for k, x in parts.items()]
    if dev.type == "cpu":
        return seed_pixel_reference(px, py, frame, seed)
    out = torch.empty(shape, dtype=torch.int64, device=dev)
    if out.numel():
        launch(entry("u32_chains", "mq_seed_pixel", _SEED_ARGS), dev,
               *[a for op in ops for a in op], out.numel(), out.data_ptr())
        seed_pixel.launches += 1
    return out


seed_pixel.launches = 0


def uniforms(state: torch.Tensor, k: int):
    """k float32 uniforms in [0, 1) from k xorshift32 steps. ``state``: u32
    values in a contiguous int64 tensor of any shape. Returns (new_state,
    u [..., k]).

    On CUDA tensors one launch of csrc/u32_chains.cu, its outputs new and
    nothing synchronized, counted in ``uniforms.launches``; on CPU tensors
    :func:`uniforms_reference`. Raises on another dtype or layout and on
    k < 1."""
    check("state", state, torch.int64, state.shape, state.device)
    if k < 1:
        raise ValueError(f"k {k}: at least one draw")
    dev = state.device
    if dev.type == "cpu":
        return uniforms_reference(state, k)
    out = torch.empty_like(state)
    u = torch.empty(tuple(state.shape) + (k,), dtype=torch.float32, device=dev)
    if state.numel():
        launch(entry("u32_chains", "mq_uniforms", _UNIFORMS_ARGS), dev,
               state.data_ptr(), state.numel(), k, out.data_ptr(), u.data_ptr())
        uniforms.launches += 1
    return out, u


uniforms.launches = 0


def uniform(state: torch.Tensor):
    """Draw one float32 uniform in [0, 1). Returns (new_state, u)."""
    state, u = uniforms(state, 1)
    return state, u[..., 0]


def uniform2(state: torch.Tensor):
    return uniforms(state, 2)


def uniform3(state: torch.Tensor):
    return uniforms(state, 3)


def uniform4(state: torch.Tensor):
    return uniforms(state, 4)
