"""Temporal accumulation (port of merian_quake_tpu/post/accumulate.py,
``accumulate`` in its reference-render form): the cumulative average."""
from __future__ import annotations


def accumulate(history, new, iteration: int):
    """history, new: f32[H, W, C]; iteration: 0-based frame counter."""
    return history + (new - history) * (1.0 / (float(iteration) + 1.0))
