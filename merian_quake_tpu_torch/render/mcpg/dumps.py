"""Guiding-state introspection dumps.

Port of merian_quake_tpu/render/mcpg/dumps.py: the reference's JSON
buffer dumps (render_mcpg.cpp:322-416 → {mc,lc,update_buffer}_dump.json,
analyzed with DuckDB queries and scripts/evaluate_locking_fast.py). Dumps
the ACTIVE subset of the hash grids plus the contention counters, as the
same JSON lines as the JAX package. Each table is read back to the host
once.
"""
from __future__ import annotations

import json

import numpy as np

from .config import MCPGState


def dump_mc(state: MCPGState, path: str, limit: int = 1_000_000):
    """Markov-chain states with sum_w > 0 → JSON lines."""
    f = state.mc.f.cpu().numpy()
    i_cols = state.mc.i.cpu().numpy()
    sw = f[:, 3]
    ids = i_cols[:, 0].astype(np.uint32)
    hashes = i_cols[:, 2].astype(np.uint32)
    idx = np.where(sw > 0)[0][:limit]
    with open(path, "w") as out:
        for i in idx:
            out.write(
                json.dumps(
                    {
                        "index": int(i),
                        "id": int(ids[i]),
                        "sum_w": float(sw[i]),
                        "w_tgt": f[i, 0:3].tolist(),
                        "w_cos": float(f[i, 4]),
                        "mv": f[i, 5:8].tolist(),
                        "T": float(f[i, 8]),
                        "N": int(i_cols[i, 1]),
                        "hash": int(hashes[i]),
                    }
                )
                + "\n"
            )
    return len(idx)


def dump_lc(state: MCPGState, path: str, limit: int = 1_000_000):
    """Light-cache entries with N > 0 → JSON lines, plus the contention
    counters (≈ update_succeeded/update_canceled, grid.h:44-45 — here:
    per-frame applied cells vs merged samples)."""
    lc = state.lc
    n = lc.N.cpu().numpy()
    hashes = lc.hash.cpu().numpy().astype(np.uint32)
    irr = lc.irr.cpu().numpy()
    idx = np.where(n > 0)[0][:limit]
    with open(path, "w") as f:
        f.write(
            json.dumps(
                {
                    "meta": {
                        "updates_applied": int(state.lc_updates_applied),
                        "updates_merged": int(state.lc_updates_merged),
                        "active_cells": int((n > 0).sum()),
                    }
                }
            )
            + "\n"
        )
        for i in idx:
            f.write(
                json.dumps(
                    {
                        "index": int(i),
                        "hash": int(hashes[i]),
                        "irr": irr[i].tolist(),
                        "N": int(n[i]),
                    }
                )
                + "\n"
            )
    return len(idx)
