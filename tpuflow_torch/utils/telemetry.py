"""Structured telemetry and the port's tracer (port of
:mod:`tpuflow.utils.telemetry`).

- :class:`Telemetry` — JSON-lines event sink, off unless installed with
  :func:`set_telemetry`;
- :class:`record_span` — a span of the program: while a ``torch.profiler``
  records (whatever its activities) keeps a :class:`Span` in memory and
  labels the block with a ``record_function`` range (seen in a trace with
  CPU activity); otherwise a flag test;
- :class:`trace_span` — a :class:`record_span` that also emits
  ``<name>.done`` with its wall seconds where a sink is installed (the
  CLI's ``pipeline.*`` stages);
- :func:`note` — counts on the innermost recorded span;
- :func:`spans` / :func:`chrome_events` — the spans of the last profiler
  window, as records or as chrome-trace events on the profiler's clock;
- :class:`EnergyTrace` — (iteration, energy) pairs per solver level, the
  reference's every-64-iterations E(n) prints (OpticalFlow.cpp:261-265).

Spans are recorded under the rule PyTorch applies to its own ops: only
while a profiler records (``torch.autograd.profiler._is_profiler_enabled``,
set on entering ``profile``). Without one a span costs a flag test (and
a :class:`trace_span` its ``.done`` event where a sink is installed): no
record, no CUDA event, no tensor. A window's list is reset at the first span recorded after a
span or a read of :func:`spans` that found no profiler recording, so
:func:`spans` reads the last window. A span records its name, its start
and end in Unix ns (the clock of ``export_chrome_trace``: an event's
``ts`` plus ``baseTimeNanoseconds`` / 1000 is Unix µs), its parent, the
frame of its top span and its fields; a span given a CUDA ``device`` also records a
timing event at entry and at exit on that device's current stream, and
its ``device_ms`` (the stream's time from the one to the other) is read
after the window, in :func:`spans`.

An operator puts the program's stages beside the kernels of a CUDA-only
trace::

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as p:
        ...                                   # frames
    p.export_chrome_trace(path)
    trace = json.load(open(path))
    trace["traceEvents"] += chrome_events(trace["baseTimeNanoseconds"])
    json.dump(trace, open(path, "w"))
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler

#: Most spans one profiler window keeps; later ones are counted, not kept.
MAX_SPANS = 1 << 17

#: The ``record_function`` range in its C++ form (inductor's): 1-2 µs a
#: range on a CPU where ``torch.profiler.record_function`` takes 10-40.
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


class Telemetry:
    def __init__(self, stream=None, enabled: bool = True):
        self.stream = stream if stream is not None else sys.stderr
        self.enabled = enabled

    def event(self, name: str, **fields) -> None:
        if not self.enabled:
            return
        rec = {"ts": time.time(), "event": name, **fields}
        print(json.dumps(rec, default=float), file=self.stream, flush=True)


_GLOBAL = Telemetry(enabled=False)


def get_telemetry() -> Telemetry:
    return _GLOBAL


def set_telemetry(t: Telemetry) -> None:
    global _GLOBAL
    _GLOBAL = t


@dataclass(eq=False)
class Span:
    """One recorded span, as :func:`spans` reads it. ``parent`` indexes
    :func:`spans` (None for a top span); ``frame`` is its top span's (a top
    span's own ``frame`` field, or the window's next number)."""

    name: str
    start_ns: int
    end_ns: int = 0
    parent: int | None = None
    frame: int | None = None
    fields: dict = field(default_factory=dict)
    device_ms: float | None = None
    index: int = 0

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class _Window:
    """The spans of one profiler window, column by column: a span adds
    numbers and interned names to lists, and a dict only where it has
    fields, so the spans of a long window give the garbage collector
    next to nothing to count (a per-span object made Black-Anandan's
    traced frames on an H100 host collect 15-60 ms of garbage each). Times
    are ``perf_counter_ns``; ``unix_offset_ns`` (Unix ns minus it, read
    once) moves them to the profiler's clock. ``tid`` is the thread that
    opened the window; the program opens spans from that one only."""

    def __init__(self):
        self.names: list[str] = []
        self.starts: list[int] = []
        self.ends: list[int] = []
        self.parents: list[int | None] = []
        self.frames: list = []
        self.fields: dict[int, dict] = {}
        self.events: dict[int, tuple] = {}
        self.device_ms: dict[int, float] = {}
        self.dropped = 0
        self.next_frame = 0
        self.unix_offset_ns = time.time_ns() - time.perf_counter_ns()
        self.tid = threading.get_native_id()

    def span(self, i: int) -> Span:
        end = self.ends[i]
        return Span(self.names[i], self.starts[i] + self.unix_offset_ns,
                    end + self.unix_offset_ns if end else 0, self.parents[i],
                    self.frames[i], self.fields.get(i, {}),
                    self.device_ms.get(i), i)


_window = _Window()
_idle = True  # the last span or read found no profiler recording
_stack: list = []  # the open spans' indices (None: one past MAX_SPANS)


def _recording() -> bool:
    global _window, _idle
    on = _autograd_profiler._is_profiler_enabled
    if on and _idle:
        _window = _Window()
        _stack.clear()
    _idle = not on
    return on


def _open(w: _Window, name: str, device, fields: dict,
          t0: int) -> int | None:
    parent = _stack[-1] if _stack else None
    if len(w.names) >= MAX_SPANS:
        w.dropped += 1
        _stack.append(parent)
        return None
    i = len(w.names)
    if parent is None:
        frame = fields.get("frame")
        if frame is None:
            frame = w.next_frame
            w.next_frame += 1
    else:
        frame = w.frames[parent]
    w.names.append(name)
    w.starts.append(t0)
    w.ends.append(0)
    w.parents.append(parent)
    w.frames.append(frame)
    if fields:
        w.fields[i] = dict(fields)
    if device is not None and torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(device))
        w.events[i] = (start, torch.cuda.Event(enable_timing=True), device)
    _stack.append(i)
    return i


def _close(w: _Window, i: int | None) -> None:
    t1 = time.perf_counter_ns()
    if _stack:
        _stack.pop()
    if i is None:
        return
    ev = w.events.get(i)
    if ev is not None:
        ev[1].record(torch.cuda.current_stream(ev[2]))
    w.ends[i] = t1


class record_span:
    """A span of the program, a context manager: while a profiler records,
    keeps a :class:`Span` in the window and opens a ``record_function``
    range; otherwise costs one flag test. ``device``: a CUDA device whose
    current stream the span's ``device_ms`` times; ``fields``: the span's
    fields (a top span's ``frame`` field is its frame)."""

    __slots__ = ("_name", "_device", "_fields", "_window", "_index",
                 "_range")

    def __init__(self, name: str, device=None, **fields):
        self._name, self._device, self._fields = name, device, fields
        self._window = self._index = self._range = None

    def __enter__(self) -> None:
        if _recording():
            self._record(time.perf_counter_ns())

    def _record(self, t0: int) -> None:
        w = self._window = _window
        self._index = _open(w, self._name, self._device, self._fields, t0)
        self._range = _RecordFunctionFast(self._name)
        self._range.__enter__()

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._range is not None:
            try:
                self._range.__exit__(exc_type, exc, tb)
            finally:
                _close(self._window, self._index)


class trace_span(record_span):
    """A :class:`record_span` that also emits ``<name>.done`` with its wall
    seconds and ``fields`` where a sink is installed."""

    __slots__ = ("_t0",)

    def __init__(self, name: str, device=None, **fields):
        super().__init__(name, device, **fields)
        self._t0 = None

    def __enter__(self) -> None:
        recording = _recording()
        if recording or _GLOBAL.enabled:
            self._t0 = time.perf_counter_ns()
            if recording:
                self._record(self._t0)

    def __exit__(self, exc_type, exc, tb) -> None:
        super().__exit__(exc_type, exc, tb)
        if self._t0 is not None and exc_type is None and _GLOBAL.enabled:
            _GLOBAL.event(f"{self._name}.done",
                          wall_s=(time.perf_counter_ns() - self._t0) * 1e-9,
                          **self._fields)


def note(**counts) -> None:
    """Put ``counts`` on the innermost recorded span:
    numbers add to what the span has, other values replace it. Nothing
    happens while no profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    if not _stack or _stack[-1] is None:
        return
    have = _window.fields.get(_stack[-1])
    if have is None:
        have = _window.fields[_stack[-1]] = {}
    for k, v in counts.items():
        number = isinstance(v, (int, float)) and not isinstance(v, bool)
        have[k] = have.get(k, 0) + v if number else v


def spans() -> list[Span]:
    """The spans of the last profiler window, in the order they opened,
    each closed span's ``device_ms`` read (waiting for its exit event)."""
    global _idle
    _idle = _idle or not _autograd_profiler._is_profiler_enabled
    w = _window
    for i in [i for i in w.events if w.ends[i]]:
        start, end, _ = w.events.pop(i)
        end.synchronize()
        w.device_ms[i] = start.elapsed_time(end)
    return [w.span(i) for i in range(len(w.names))]


def dropped() -> int:
    """Spans the last window recorded past :data:`MAX_SPANS`."""
    return _window.dropped


def chrome_events(base_time_ns: int = 0) -> list[dict]:
    """:func:`spans` as chrome-trace ``"X"`` events (category
    ``tpuflow_span``) whose ``ts`` counts µs from ``base_time_ns``: pass
    an exported trace's ``baseTimeNanoseconds`` to append them to its
    ``traceEvents``. ``args`` hold the fields, the frame, the parent and
    ``device_ms``."""
    pid, tid = os.getpid(), _window.tid
    out = []
    for s in spans():
        args = dict(s.fields, frame=s.frame, parent=s.parent)
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        out.append({"ph": "X", "cat": "tpuflow_span", "name": s.name,
                    "pid": pid, "tid": tid,
                    "ts": (s.start_ns - base_time_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


@dataclass
class EnergyTrace:
    """Per-level IRLS energy trace (the reference's E(n) prints)."""

    levels: dict = field(default_factory=dict)

    def record(self, level: int, iteration: int, energy: float) -> None:
        self.levels.setdefault(level, []).append((iteration, float(energy)))
        get_telemetry().event("irls.energy", level=level,
                              iteration=iteration, energy=float(energy))

    def as_dict(self) -> dict:
        return {str(k): v for k, v in self.levels.items()}
