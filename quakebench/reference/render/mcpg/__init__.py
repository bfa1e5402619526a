"""Markov Chain Path Guiding (MCPG) — the flagship integrator.

Port of merian_quake_tpu/render/mcpg: two world-space hash grids of
Markov-chain vMF states steer path directions (and, in the volume pass,
single-scattering directions, beside per-tile distance mixtures); paths
emit update samples that are replayed into the chains in a second
phase; a light cache stores EWA irradiance for path tails.

Updates are dense masked sample arrays, grouped by cell with one sort
(ops/segments.py), replayed with a batched EWA and an exponential-race
weighted-reservoir winner per cell.
"""
from .config import MCPGConfig, MCPGState, init_mcpg_state  # noqa: F401
from .surface import render_mcpg_surface  # noqa: F401
from .updates import apply_updates  # noqa: F401
