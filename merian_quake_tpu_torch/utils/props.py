"""Headless live property editing.

The reference drives every node knob through one Properties tree with
an ImGui editor AND JSON config files
(the reference's src/configuration.hpp:30-39); diffing decides no-op vs
pipeline rebuild vs graph reconnect (render_mcpg.cpp:419-578). The
rebuild's equivalent, headless: a :class:`PropertyConsole` watches a
JSON patch file (and optionally stdin lines ``set key value``) while
``cli play`` runs, and :func:`apply_patches` maps the patches onto the
static config dataclasses between frames — a changed static field IS
the pipeline rebuild (the renderer takes the new static config), and
patches that resize persistent state report ``needs_reinit`` (the
reconnect equivalent: the caller re-inits FrameState).

Copy of merian_quake_tpu/utils/props.py (jax-free).
"""
from __future__ import annotations

import json
import os
import select
import sys
from typing import Any

# RenderConfig fields whose change requires re-initializing FrameState
# (the reference's NEEDS_RECONNECT: resources must be reallocated)
_RECONNECT_FIELDS = {"width", "height", "integrator", "denoise"}


class PropertyConsole:
    """Poll a JSON patch file and/or stdin for property changes.

    File protocol: the whole file is a JSON object of dotted keys →
    values (e.g. ``{"mcpg.surf_bsdf_p": 0.3, "spp": 2}``); every mtime
    change re-reads it and emits the keys that CHANGED since last read.
    Stdin protocol (``stdin=True``): lines ``set <key> <json-value>``.
    """

    def __init__(self, path: str | None = None, use_stdin: bool = False):
        self.path = path
        self.use_stdin = use_stdin
        self._mtime = None
        self._last: dict[str, Any] = {}
        if path and os.path.exists(path):
            # baseline: contents at startup count as already-applied
            try:
                self._last = dict(json.load(open(path)))
                self._mtime = os.stat(path).st_mtime
            except (OSError, json.JSONDecodeError):
                pass

    def poll(self) -> dict[str, Any]:
        patches: dict[str, Any] = {}
        if self.path:
            try:
                mt = os.stat(self.path).st_mtime
            except OSError:
                mt = None
            if mt is not None and mt != self._mtime:
                self._mtime = mt
                try:
                    cur = dict(json.load(open(self.path)))
                except (OSError, json.JSONDecodeError):
                    cur = None
                if cur is not None:
                    for k, v in cur.items():
                        if self._last.get(k) != v:
                            patches[k] = v
                    self._last = cur
        if self.use_stdin:
            while True:
                r, _, _ = select.select([sys.stdin], [], [], 0)
                if not r:
                    break
                line = sys.stdin.readline()
                if not line:
                    break
                parts = line.strip().split(None, 2)
                if len(parts) == 3 and parts[0] == "set":
                    try:
                        patches[parts[1]] = json.loads(parts[2])
                    except json.JSONDecodeError:
                        patches[parts[1]] = parts[2]
        return patches


def apply_patches(config, mcpg_config, patches: dict):
    """Map dotted-key patches onto (RenderConfig, integrator config).

    Keys: bare names patch RenderConfig fields; ``mcpg.<f>`` /
    ``restir.<f>`` / ``ssmm.<f>`` patch the integrator config;
    ``volume.<f>`` patches MCPGConfig.volume. Unknown keys are
    reported, not fatal (the reference logs unknown properties).
    Returns (config, mcpg_config, needs_reinit, unknown_keys).
    """
    needs_reinit = False
    unknown = []
    for key, val in patches.items():
        scope, _, field = key.partition(".")
        if not field:
            scope, field = "", key
        if scope == "":
            if hasattr(config, field):
                config = config._replace(
                    **{field: _cast(val, getattr(config, field))}
                )
                if field in _RECONNECT_FIELDS:
                    needs_reinit = True
            else:
                unknown.append(key)
        elif scope in ("mcpg", "restir", "ssmm") and mcpg_config is not None:
            if hasattr(mcpg_config, field):
                old = getattr(mcpg_config, field)
                mcpg_config = mcpg_config._replace(**{field: _cast(val, old)})
                if field.endswith("_size"):
                    needs_reinit = True
            else:
                unknown.append(key)
        elif scope == "volume" and mcpg_config is not None and getattr(
            mcpg_config, "volume", None
        ) is not None:
            vol = mcpg_config.volume
            if hasattr(vol, field):
                old = getattr(vol, field)
                mcpg_config = mcpg_config._replace(
                    volume=vol._replace(**{field: _cast(val, old)})
                )
            else:
                unknown.append(key)
        else:
            unknown.append(key)
    return config, mcpg_config, needs_reinit, unknown


def _cast(val, old):
    """Coerce a JSON value to the old field's type (static configs are
    type-stable: float stays float, int int, bool bool)."""
    if isinstance(old, bool):
        return bool(val)
    if isinstance(old, int) and not isinstance(old, bool):
        return int(val)
    if isinstance(old, float):
        return float(val)
    if isinstance(old, tuple) and isinstance(val, (list, tuple)):
        return tuple(val)
    return val
