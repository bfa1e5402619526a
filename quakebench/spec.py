"""Lookup by name: the benchmark's file, its cells, configurations,
traffic mixes, drivers and metric readers."""
from __future__ import annotations

import importlib
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def valid_name(kind: str, name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a {kind} name: {name!r}")
    return name


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, valid_name(kind, name) + ".json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _load_json("configs", name)


def traffic(name: str) -> dict:
    return _load_json("traffic", name)


def metric(name: str):
    """The reader module of metric ``name``: ``quakebench/metrics/<name>.py``
    with ``read(run) -> float | None`` (None: nothing to read here)."""
    return importlib.import_module(f"quakebench.metrics.{valid_name('metric', name)}")


def driver(name: str):
    """The module that moves a traffic mix's world: ``quakebench/drivers/<name>.py``
    (quakebench/drivers/__init__.py says what it defines)."""
    return importlib.import_module(f"quakebench.drivers.{valid_name('driver', name)}")


def cell(bench: dict, name: str) -> dict:
    """The ``workloads`` entry named ``name``; raises KeyError if none."""
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> list:
    """The metrics a run of ``cell_name`` reports: the end-to-end ones
    (``trace`` False) or the per-layer ones (True), each where its
    ``workloads`` key names this cell or, without the key, everywhere."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]
