"""Structured telemetry (port of :mod:`tpuflow.utils.telemetry`).

- :class:`Telemetry` — JSON-lines event sink, off unless installed with
  :func:`set_telemetry`;
- :func:`trace_span` — a timed block that emits ``<name>.done`` with its
  wall seconds; ``profile=True`` also marks it in a ``torch.profiler``
  trace (tpuflow marks it in a ``jax.profiler`` one);
- :class:`EnergyTrace` — (iteration, energy) pairs per solver level, the
  reference's every-64-iterations E(n) prints (OpticalFlow.cpp:261-265).
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field


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


@contextlib.contextmanager
def trace_span(name: str, profile: bool = False, **fields):
    """Timed span: emits '<name>.done' with wall seconds; optionally
    labels the block in the profiler's trace."""
    t0 = time.perf_counter()
    ctx = contextlib.nullcontext()
    if profile:
        import torch.profiler

        ctx = torch.profiler.record_function(name)
    with ctx:
        yield
    _GLOBAL.event(f"{name}.done", wall_s=time.perf_counter() - t0, **fields)


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
