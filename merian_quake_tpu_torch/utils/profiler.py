"""The port's tracer: spans and counters at its layer boundaries, inside
the captured frame too.

Port of merian_quake_tpu/utils/profiler.py (Merian's MERIAN_PROFILE_SCOPE
and _GPU scopes), redesigned for a frame that runs as one CUDA graph:

- ``span(name, like=None)`` is a context manager around a stage. On the
  host it opens a range ``mq.<name>`` of the profiler (so that a profile
  shows it on the clock of the device operations) and reads
  ``time.perf_counter()`` at both ends. The range is recorded as an
  operator (``_RecordFunctionFast``), not as ``record_function``'s user
  annotation, which the profiler would also put on the device's timeline
  over the kernels launched inside it, where it reads as a device
  operation as long as the whole replay. Given a CUDA tensor
  ``like``, it also records a timing event on that device's current
  stream at both ends. Inside ``torch.cuda.graph`` capture (``capture``)
  those events become event-record nodes of the graph, kept once in the
  captured step's stage table (:class:`StageTable`): every replay times
  them again with no Python running.
- ``count(name, value)`` adds ``value`` (a tensor or a number) to a
  counter. Inside the capture the add is a node of the graph into the
  table's device buffer, which the graph zeroes at each replay; a Python
  number is a constant of every replay. A value that costs work to make
  is made under ``counting()``.

Recording is on while a ``torch.profiler`` session is active in the
process, or while an operator's ``Profiler(enabled=True)`` is installed
(``install``). Off, a span or a count costs one test on the host and
records nothing; a captured graph keeps its event nodes and its
counters' few small kernels, and nothing synchronizes. On, a frame's
events and counters are read when the next frame is replayed or at
``summary()``, by which time the caller has synchronized: the reading
adds no wait, and at most one device-to-host read a frame.

Frames. A frame opens at its first recorded span (the game step of a
live frame, the replay call of a still one) and closes when its render
returns (``replay``, ``frame``); its id counts the frames this tracer has
seen. Every span carries its frame's id and its parent (the span that was
open around it). At the frame's opening one event is recorded on the
device, the anchor: the stream is idle then, so every device span of the
frame is placed on the host clock from it. The top-level device spans of
a frame tile it: each starts at the previous one's end event, so the
replay's lead and the top-level spans of the graph add up to the device
time from the replay call to the graph's end (``summary()["replays"]``).

A recording session starts at the first recorded frame after one that
was not recorded; ``summary()`` and ``records()`` cover the last
session. Spans stay in memory; nothing is written to a file.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import torch

# device counters a captured step may hold
MAX_COUNTERS = 16


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def _range(name: str):
    return torch._C._profiler._RecordFunctionFast(name)


def _event(device) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class StageTable:
    """A captured step's stages, recorded once at the capture: ``rows``
    (name, parent, start event, end event), the device counters' buffer
    ``counts`` (i64[MAX_COUNTERS], zeroed by the graph at its first
    count) with ``slots`` {name: index}, and ``consts`` {name: number},
    the counts every replay adds."""

    def __init__(self, device):
        self.device = device
        self.rows: list = []
        self.counts = None
        self.slots: dict[str, int] = {}
        self.consts: dict[str, float] = {}

    def add(self, name: str, value) -> None:
        if isinstance(value, (int, float)):
            self.consts[name] = self.consts.get(name, 0) + value
            return
        if self.counts is None:
            self.counts = torch.zeros(MAX_COUNTERS, dtype=torch.int64, device=self.device)
        slot = self.slots.setdefault(name, len(self.slots))
        if slot >= MAX_COUNTERS:
            raise ValueError(f"a captured step counts at most {MAX_COUNTERS} device counters")
        self.counts[slot].add_(value)


class _Frame:
    def __init__(self, fid: int, anchor, t_anchor: float):
        self.id = fid
        self.anchor, self.t_anchor = anchor, t_anchor
        self.spans: list = []  # (name, parent, t0, t1, start event, end event)
        self.replays: list = []  # (stage table, replay's first event)
        self.counts: dict = {}


_NULL = nullcontext()


class _Span:
    __slots__ = ("p", "name", "dev", "fr", "parent", "top", "t0", "ev0", "rf")

    def __init__(self, p: "Profiler", name: str, like):
        self.p, self.name = p, name
        self.dev = like.device if like is not None and like.is_cuda else None

    def __enter__(self):
        p = self.p
        self.parent = p._stack[-1] if p._stack else None
        self.top = self.parent is None
        if p._table is not None:
            # inside the capture: device events only, into the stage table
            if self.dev is not None:
                self.ev0 = p._chain if self.top and p._chain is not None else _event(self.dev)
            p._stack.append(self.name)
            return self
        opened = p._cur is None
        self.fr = p._cur if not opened else p._open_frame(self.dev)
        p._stack.append(self.name)
        self.rf = _range("mq." + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        self.ev0 = None
        if self.dev is not None:
            if opened and self.fr.anchor is not None:
                self.ev0 = self.fr.anchor
            elif self.top and p._chain is not None:
                self.ev0 = p._chain
            else:
                self.ev0 = _event(self.dev)
        return self

    def __exit__(self, *exc):
        p = self.p
        p._stack.pop()
        ev1 = _event(self.dev) if self.dev is not None else None
        if self.top and ev1 is not None:
            p._chain = ev1
        if p._table is not None:
            if ev1 is not None:
                p._table.rows.append((self.name, self.parent, self.ev0, ev1))
            return False
        t1 = time.perf_counter()
        self.rf.__exit__(*exc)
        self.fr.spans.append((self.name, self.parent, self.t0, t1, self.ev0, ev1))
        return False


class _FrameScope:
    def __init__(self, p: "Profiler", like=None):
        self.p, self.like = p, like

    def __enter__(self):
        p = self.p
        p._depth += 1
        if p._cur is None:
            p._open_frame(self.like.device if self.like is not None and self.like.is_cuda
                          else None)
        return self

    def __exit__(self, *exc):
        p = self.p
        p._depth -= 1
        if p._depth == 0 and p._cur is not None:
            p._pending.append(p._cur)
            p._cur, p._chain = None, None
        return False


class Profiler:
    """Spans and counters (see the module's docstring). ``enabled``:
    record whether or not a ``torch.profiler`` session is active."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._table = None  # the stage table of the step being captured
        self._stack: list[str] = []  # the open spans
        self._chain = None  # end event of the frame's last top-level device span
        self._cur = None  # the open frame
        self._depth = 0  # open frame scopes
        self._frame = 0  # frames seen
        self._was_on = False
        self._pending: list[_Frame] = []  # closed frames not yet read
        self.reset()

    def reset(self) -> None:
        """Drop what was recorded."""
        self._records: list[tuple] = []  # (frame, name, parent, ms, start_s, end_s)
        self._counters: dict[str, float] = defaultdict(float)
        self._replays: list[float] = []
        self._frames: set[int] = set()
        self._pending = []

    def counting(self) -> bool:
        """Would a count be kept: inside a capture, or recording."""
        return self._table is not None or self.enabled or _profiling()

    # ---- the program's side ----

    def span(self, name: str, like=None):
        if self._table is None and not (self.enabled or _profiling()):
            return _NULL
        return _Span(self, name, like)

    def count(self, name: str, value) -> None:
        if not self.counting():
            return
        if self._table is not None:
            self._table.add(name, value)
            return
        fr = self._cur if self._cur is not None else self._open_frame(None)
        fr.counts[name] = fr.counts.get(name, 0) + value

    def frame(self, like=None):
        """The scope of one frame's render (frame_core): a frame opens
        at its start unless one is open, and closes at its end."""
        if self._table is not None:
            return _NULL
        if not (self.enabled or _profiling()):
            self._mark_off()
            return _NULL
        return _FrameScope(self, like)

    @contextmanager
    def capture(self, like):
        """Inside ``torch.cuda.graph``: the step's spans and counts go into
        the yielded StageTable of ``like``'s device."""
        table = StageTable(like.device)
        saved = self._table, self._stack, self._chain
        self._table, self._stack, self._chain = table, [], None
        try:
            yield table
        finally:
            self._table, self._stack, self._chain = saved

    def replay(self, table: StageTable, load, launch, like) -> None:
        """A captured step's call: ``load()`` writes its inputs, ``launch()``
        replays its graph. Recorded, it is the span ``replay.lead`` (its
        start to the graph's first event) with children ``replay.inputs``
        and ``replay.launch``, and the graph's stage table is read with
        the frame. The previous frames' events are read first, before the
        graph records its events again."""
        if self._pending:
            self._harvest()
        if not (self.enabled or _profiling()):
            self._mark_off()
            load()
            launch()
            return
        dev = like.device
        with _FrameScope(self, like):
            fr = self._cur
            first = not fr.spans and not fr.replays and fr.anchor is not None
            with _range("mq.replay.lead"):
                t0 = time.perf_counter()
                e0 = fr.anchor if first else _event(dev)
                with _range("mq.replay.inputs"):
                    load()
                t1 = time.perf_counter()
                e1 = _event(dev)
                with _range("mq.replay.launch"):
                    launch()
                t2 = time.perf_counter()
            g0 = table.rows[0][2] if table.rows else None
            fr.spans += [("replay.lead", None, t0, t2, e0, g0),
                         ("replay.inputs", "replay.lead", t0, t1, e0, e1),
                         ("replay.launch", "replay.lead", t1, t2, e1, g0)]
            fr.replays.append((table, e0))

    def _mark_off(self) -> None:
        if self._cur is not None:
            self._pending.append(self._cur)
            self._cur = None
        self._depth, self._chain, self._was_on = 0, None, False
        self._frame += 1

    def _open_frame(self, device) -> _Frame:
        if not self._was_on:
            self.reset()  # a new recording session
        self._was_on = True
        self._frame += 1
        if device is None and torch.cuda.is_available() and torch.cuda.is_initialized():
            device = torch.device("cuda", torch.cuda.current_device())
        t = time.perf_counter()
        self._cur = _Frame(self._frame, _event(device) if device is not None else None, t)
        self._chain = None
        return self._cur

    # ---- reading ----

    def _harvest(self) -> None:
        """Read the closed frames' events and counters."""
        pending, self._pending = self._pending, []
        for fr in pending:
            self._read(fr)

    def _read(self, fr: _Frame) -> None:
        def place(ev0, ev1, t0, t1):
            if ev0 is None or ev1 is None:
                return (t1 - t0) * 1e3, t0, t1
            ev1.synchronize()
            ms = ev0.elapsed_time(ev1)
            if fr.anchor is None:
                return ms, None, None
            s = fr.t_anchor + fr.anchor.elapsed_time(ev0) * 1e-3
            return ms, s, s + ms * 1e-3

        self._frames.add(fr.id)
        for name, parent, t0, t1, ev0, ev1 in fr.spans:
            self._records.append((fr.id, name, parent, *place(ev0, ev1, t0, t1)))
        for table, e0 in fr.replays:
            for name, parent, ev0, ev1 in table.rows:
                self._records.append((fr.id, name, parent, *place(ev0, ev1, 0.0, 0.0)))
            if table.rows:
                table.rows[-1][3].synchronize()
                self._replays.append(e0.elapsed_time(table.rows[-1][3]))
            if table.counts is not None:
                values = table.counts.tolist()
                for name, slot in table.slots.items():
                    self._counters[name] += values[slot]
            for name, v in table.consts.items():
                self._counters[name] += v
        tensors = [(k, v) for k, v in fr.counts.items() if isinstance(v, torch.Tensor)]
        if tensors:
            values = torch.stack([v.reshape(()).to(torch.float64) for _, v in tensors]).tolist()
            for (name, _), v in zip(tensors, values):
                self._counters[name] += v
        for name, v in fr.counts.items():
            if not isinstance(v, torch.Tensor):
                self._counters[name] += v

    def _flush(self) -> None:
        if self._cur is not None and self._depth == 0:
            self._pending.append(self._cur)
            self._cur, self._chain = None, None
        self._harvest()

    def records(self) -> list[dict]:
        """Every recorded span: frame, name, parent, ms (the device's time
        where the span has events, else the host's), and its start and end
        on the host clock (``time.perf_counter()``, s; None for a device
        span of a frame without an anchor)."""
        self._flush()
        keys = ("frame", "name", "parent", "ms", "start_s", "end_s")
        return [dict(zip(keys, r)) for r in self._records]

    def summary(self) -> dict:
        """``frames``: the frames recorded; ``spans``: {name: {parent, ms,
        count, self_ms (ms less its children's), frames}}; ``counters``:
        {name: total}; ``replays``: {frames, ms}, the device time from each
        replay call to its graph's end."""
        self._flush()
        spans: dict[str, dict] = {}
        child_ms: dict[str, float] = defaultdict(float)
        frames: dict[str, set] = defaultdict(set)
        for fid, name, parent, ms, _, _ in self._records:
            s = spans.setdefault(name, {"parent": parent, "ms": 0.0, "count": 0})
            s["ms"] += ms
            s["count"] += 1
            frames[name].add(fid)
            if parent is not None:
                child_ms[parent] += ms
        for name, s in spans.items():
            s["self_ms"] = s["ms"] - child_ms[name]
            s["frames"] = len(frames[name])
        return {"frames": len(self._frames), "spans": spans, "counters": dict(self._counters),
                "replays": {"frames": len(self._replays), "ms": sum(self._replays)}}

    def report(self) -> str:
        """``summary()`` as text: a line a span, by total time."""
        s = self.summary()
        n = max(s["frames"], 1)
        lines = [f"profiler report ({s['frames']} frames; ms a frame):"]
        for name, v in sorted(s["spans"].items(), key=lambda kv: -kv[1]["ms"]):
            lines.append(f"  {name:<28} {v['ms'] / n:9.3f} ms  self {v['self_ms'] / n:9.3f} ms"
                         f"  x{v['count']}")
        for name, v in sorted(s["counters"].items()):
            lines.append(f"  {name:<28} {v / n:14.1f} a frame")
        return "\n".join(lines)


_ACTIVE = Profiler()


def install(profiler: Profiler) -> Profiler:
    """Make ``profiler`` the one the port's spans and counters go to;
    returns the one it replaces."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, profiler
    return prev


def active() -> Profiler:
    return _ACTIVE


def span(name: str, like=None):
    """The active tracer's span (``Profiler.span``)."""
    return _ACTIVE.span(name, like)


def count(name: str, value) -> None:
    """The active tracer's counter (``Profiler.count``)."""
    _ACTIVE.count(name, value)


def counting() -> bool:
    return _ACTIVE.counting()


def frame(like=None):
    return _ACTIVE.frame(like)


def summary() -> dict:
    return _ACTIVE.summary()


def records() -> list[dict]:
    return _ACTIVE.records()
