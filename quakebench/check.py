"""What decides ``correct``: the frame that the program's compiled frame
produces right after the window, held to the plain reference's frame
from the same start.

The reference follows the program step by step: it starts from the
program's frame state after the window's last frame (the guiding chains,
light cache and distance states, ReSTIR's reservoirs, the denoiser's and
the accumulators' histories), renders the next frame with its own tables
and trace on the same uniforms (and, live, the same game step), and the
two frames are compared leaf by leaf. The start and the step that this
skips are checked on their own: the program's initial state against the
reference's (``start``) and, where the mix's world step writes tables each
frame (a live mix), the program's refreshed dynamic tables against the
reference's rows of the same game step (``tables``).

A leaf's error is the share of its elements that differ (``leaf_error``:
a float by more than RTOL of itself plus RTOL of the leaf's mean
magnitude, an integer at all; a counter by its relative difference).
Leaves are matched by their path of field names and keys, never by
class or module, and compared by value whatever their dtype. Each
compared number is the worst leaf of its group. Where both sides pick
the same triangle they compute the same bits on the card, so a sound
frame differs only around the rare rays whose nearest triangle is a tie
within rounding.
"""
from __future__ import annotations

import torch

RTOL = 1e-3
# each number's limit, between the largest reading of sound runs on the
# card and the smallest of the control (the reference with bfloat16 hits);
# the readings are in PERF.md, section 2. The start and the refreshed
# tables are exact.
LIMITS = {
    "start": 0.0,
    "tables": 0.0,
    "gbuffer": 1e-3,
    "image": 1e-2,
    "state": 1e-2,
}


def leaf_error(p: torch.Tensor, r: torch.Tensor) -> float:
    """The share of ``p``'s elements that differ from ``r``'s: for floats,
    by more than RTOL of the element plus RTOL of the leaf's mean
    magnitude (NaN against a number differs, NaN against NaN does not);
    for integers and booleans, at all; for a counter (an integer
    scalar), its relative difference. The same number of elements in
    another layout is compared in ``r``'s; another number: 1."""
    if p.shape != r.shape:
        if p.numel() != r.numel():
            return 1.0
        p = p.reshape(r.shape)
    if p.numel() == 0:
        return 0.0
    if not (p.dtype.is_floating_point or r.dtype.is_floating_point):
        if p.numel() == 1 and p.dtype != torch.bool:
            return abs(int(p) - int(r)) / max(abs(int(r)), 1)
        return float((p != r).double().mean())
    p, r = p.double(), r.double()
    pn, rn = torch.isnan(p), torch.isnan(r)
    p, r = torch.where(pn, 0.0, p), torch.where(rn, 0.0, r)
    tol = RTOL * r.abs() + RTOL * float(r.abs().mean())
    return float(((pn != rn) | ((p - r).abs() > tol)).double().mean())


def leaves(x, prefix="") -> dict:
    """{path: tensor} of NamedTuples, dicts, tuples and lists."""
    if isinstance(x, torch.Tensor):
        return {prefix: x}
    out = {}
    if isinstance(x, dict):
        items = x.items()
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        items = zip(x._fields, x)
    elif isinstance(x, (tuple, list)):
        items = enumerate(x)
    else:
        return out
    for k, v in items:
        out.update(leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def worst(prog, ref) -> tuple:
    """(worst leaf error, its path) over the leaves of ``ref``; a leaf the
    program lacks is an infinite error."""
    p, r = leaves(prog), leaves(ref)
    err, where = 0.0, ""
    for k, rv in r.items():
        e = leaf_error(p[k], rv) if k in p else 1.0
        if e > err or not where:
            err, where = e, k
    return err, where


def judge(numbers: dict) -> bool:
    """Every number at or under its limit."""
    return all(v <= LIMITS[k] for k, v in numbers.items())


def report(numbers: dict) -> dict:
    """{name: {"value", "limit"}} for the result line."""
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in numbers.items()}


def tables_error(program_rows: dict, ref_rows: dict) -> tuple:
    """The program's refreshed dynamic tables against the reference's rows
    of the same game step: the worst share of differing elements."""
    return worst(program_rows, {k: torch.as_tensor(v) for k, v in ref_rows.items()
                                if k in program_rows})
