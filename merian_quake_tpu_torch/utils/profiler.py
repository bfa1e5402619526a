"""Scoped CPU/device profiler.

Port of merian_quake_tpu/utils/profiler.py: Merian's profiler
(MERIAN_PROFILE_SCOPE / _GPU spans with periodic aggregated reports).
A device span ends in ``torch.cuda.synchronize()`` of the device of
each tensor handed to it (the counterpart of JAX's
``block_until_ready``), so it measures the work submitted inside the
scope; on the CPU torch runs synchronously and the span only reads the
clock. Use sparingly in production loops: the host waits for the card at
every span's end, like a timestamp query in the reference.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


def _sync(holder) -> None:
    """Wait for the devices of the CUDA tensors in ``holder`` (nested
    lists, tuples, dicts and NamedTuples of tensors)."""
    devices, stack = set(), list(holder)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


class Profiler:
    def __init__(self, enabled: bool = True, report_every: int = 50):
        self.enabled = enabled
        self.report_every = report_every
        self._acc: dict[str, float] = defaultdict(float)
        self._count: dict[str, int] = defaultdict(int)
        self._runs = 0

    @contextmanager
    def cpu(self, name: str):
        """CPU span (host work: game step, accel build, readbacks)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t0
            self._count[name] += 1

    @contextmanager
    def device(self, name: str):
        """Device span: waits at its end for the devices of the tensors
        appended to the yielded list."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        holder = []
        try:
            yield holder
        finally:
            if holder:
                _sync(holder)
            self._acc[name] += time.perf_counter() - t0
            self._count[name] += 1

    def frame_done(self) -> str | None:
        """Call once per frame; returns a report string every
        ``report_every`` frames (≈ the reference's ImGui report)."""
        self._runs += 1
        if self._runs % self.report_every != 0:
            return None
        return self.report()

    def report(self) -> str:
        lines = ["profiler report (avg ms over counted scopes):"]
        for name in sorted(self._acc, key=lambda n: -self._acc[n]):
            avg = self._acc[name] / max(self._count[name], 1) * 1000
            total = self._acc[name] * 1000
            lines.append(
                f"  {name:<32} avg {avg:8.2f} ms  total {total:9.1f} ms"
                f"  x{self._count[name]}"
            )
        return "\n".join(lines)

    def reset(self):
        self._acc.clear()
        self._count.clear()
        self._runs = 0
