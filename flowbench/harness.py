"""The benchmark's general part: it finds a cell's pieces by name, times the
window, traces it, counts, and judges the outputs.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric lives in a file of its own under ``flowbench/``, found by
the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment; ``driver`` and ``reference``
  name its driver and its plain reference;
- ``traffic/<traffic>.json``: the mix's parameters; ``generator`` names the
  seeded generator ``traffic/<generator>.py``;
- ``cells/<cell>.json``: the steps of warm-up, tracing and counting, the
  samples checked and the limit of every number compared;
- ``drivers/<driver>.py``: how the entry point is driven, one step a frame;
- ``metrics/<metric>.py``: one reader per per-layer metric;
- ``reference/<config>.py``: the plain reference.

Adding a cell, a configuration or a metric adds files and entries; no file
here changes.
"""

from __future__ import annotations

import importlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
#: Top-level modules that no process of the benchmark may hold: the JAX
#: stack and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpuflow")


def load_json(kind: str, name: str) -> dict:
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    return importlib.import_module(f"flowbench.{kind}.{name}")


def forbidden_modules() -> list[str]:
    """The forbidden top-level names in ``sys.modules`` (compared whole:
    ``tpuflow_torch`` is not ``tpuflow``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files loaded."""

    name: str
    config: dict
    traffic: dict
    cell: dict
    end_to_end: list
    per_layer: list
    chips: int

    @classmethod
    def load(cls, name: str) -> "Cell":
        bench = json.loads((REPO / "BENCHMARK.json").read_text())
        for wl in bench["workloads"]:
            if wl["name"] == name:
                break
        else:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")

        def mine(metric):
            return name in metric.get("workloads", [name])

        return cls(name=name,
                   config=load_json("configs", wl["config"]),
                   traffic=load_json("traffic", wl["traffic"]),
                   cell=load_json("cells", name),
                   end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                   per_layer=[m for m in bench["per_layer"] if mine(m)],
                   chips=int(wl["chips"]))


@dataclass
class Context:
    """What a driver gets: the cell, the seed, the device, the traffic."""

    cell: Cell
    seed: int
    device: str
    trace: bool
    traffic: object = None
    rng: np.random.Generator = None

    def __post_init__(self):
        gen = load_module("traffic", self.cell.traffic["generator"])
        self.traffic = gen.make(self.cell.traffic, self.cell.config,
                                self.seed)
        self.rng = np.random.default_rng([int(self.seed), 0xC4EC])


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length,
    drawn from ``rng`` (the same seed and stream give the same sample)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


# -- device trace -------------------------------------------------------------

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class DeviceTrace:
    """The device's activity in a traced window: seconds per device op
    name, the busy seconds (union of op intervals), the longest idle gaps
    with the CUDA call the host was in, if any."""

    op_s: dict = field(default_factory=dict)
    busy_s: float = 0.0
    gaps: list = field(default_factory=list)


def read_chrome_trace(path: Path, top: int = 10) -> DeviceTrace:
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    dev, host = [], []
    out = DeviceTrace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in _DEVICE_CATS:
            dev.append((ts, ts + dur))
            name = e.get("name", "")
            out.op_s[name] = out.op_s.get(name, 0.0) + dur * 1e-6
        elif cat in _HOST_CATS:
            host.append((ts, ts + dur, e.get("name", "")))
    if not dev:
        return out
    dev.sort()
    merged = [list(dev[0])]
    for a, b in dev[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    out.busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:top]
    host.sort()
    starts = np.array([h[0] for h in host]) if host else np.zeros(0)
    for length, a, b in gaps:
        best, label = 0.0, "host: no CUDA call traced"
        lo = max(int(np.searchsorted(starts, a)) - 64, 0)
        hi = int(np.searchsorted(starts, b))
        for s, e, name in host[lo:hi]:
            ov = min(e, b) - max(s, a)
            if ov > best:
                best, label = ov, f"host in {name}"
        out.gaps.append((label, length * 1e-6))
    return out


def trace_window(steps, device: str):
    """Run ``steps()`` under ``torch.profiler`` tracing the device's
    activity only (host op events cost the profiler a minute on a frame of
    ~10^5 eager ops); returns (result, DeviceTrace, window seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    acts = [ProfilerActivity.CUDA] if device != "cpu" else [
        ProfilerActivity.CPU]
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = steps()
        sync()
        window_s = time.perf_counter() - t0
    fd, name = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(name)
        trace = read_chrome_trace(Path(name))
    finally:
        os.unlink(name)
    return result, trace, window_s


# -- counting -----------------------------------------------------------------


def count_work(steps, device: str):
    """Run ``steps()`` counting the synchronising calls PyTorch reports
    (``torch.cuda.set_sync_debug_mode``) and the ATen ops dispatched on
    tensors of ``device``; returns (result, syncs, ops)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    dev_type = torch.device(device).type

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            flat = tree_flatten((args, kwargs, out))[0]
            if any(isinstance(t, torch.Tensor) and t.device.type == dev_type
                   for t in flat):
                Count.ops += 1
            return out

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if dev_type == "cuda":
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with Count():
                result = steps()
        finally:
            if dev_type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return result, syncs, Count.ops


def program_kernels() -> set[str]:
    """The kernel names the program's own CUDA sources define."""
    names = set()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    for src in (REPO / "tpuflow_torch" / "csrc").glob("*.cu"):
        names.update(pat.findall(src.read_text()))
    return names


def kernel_s(trace: DeviceTrace, kernel: str) -> float:
    """Device seconds of the kernel ``kernel`` (a template instance or
    not)."""
    pat = re.compile(rf"(^|[^\w]){re.escape(kernel)}\s*[<(]")
    return sum(s for name, s in trace.op_s.items() if pat.search(name))


# -- the run -----------------------------------------------------------------


def device_info(device: str, chips: int) -> dict:
    """The result's ``device``: the card, the cards used, the peak memory
    of the process and the card's power limit (a CPU run, the tests',
    reports the CPU)."""
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__("forbidden modules loaded: " + ", ".join(found))


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None,
        overrides: dict | None = None) -> dict:
    """One run of the cell ``name``; returns the result object (the
    ``checks`` key last). ``device="cpu"`` runs the same path on the
    CPU (the tests' small runs); ``overrides`` replaces config and
    traffic keys (the tests' crops)."""
    if t_start is None:
        t_start = time.perf_counter()
    cell = Cell.load(name)
    for part, keys in (overrides or {}).items():
        getattr(cell, part).update(keys)
    ctx = Context(cell, seed, device, trace)
    drv = load_module("drivers", cell.config["driver"]).make(ctx)
    drv.warmup()
    if trace:
        return _traced(ctx, drv)
    sample = Reservoir(int(cell.cell["check_samples"]), ctx.rng)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    done, lat = [], []
    while True:
        rec = drv.step()
        done.append(rec["t_done"] - t0)
        lat.append(1e3 * (rec["t_done"] - rec["t_in"]))
        sample.offer(rec)
        if done[-1] >= seconds:
            break
    window_s = done[-1]
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    dev = device_info(device, cell.chips)
    values = {"frames_per_s": len(done) / window_s, "setup_s": setup_s,
              "frame_ms_p95": float(np.percentile(lat, 95))}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end}
    drv.release()
    checks, failed = _judge(drv, cell, sample.items)
    return {"correct": failed == 0, "attempted": len(done),
            "failed": failed, "metrics": metrics, "device": dev,
            "checks": checks}


def _judge(drv, cell: Cell, samples) -> tuple[dict, int]:
    """Every number compared, the worst over the samples, beside its
    limit; and the samples that failed one."""
    limits = cell.cell["limits"]
    worst, failed = {}, 0
    for rec in samples:
        got = drv.check(rec)
        bad = False
        for k, v in got.items():
            worst[k] = max(worst.get(k, -np.inf), v)
            bad |= not v <= limits[k]
        failed += bad
    if not samples:
        failed = 1
    return ({k: {"value": worst[k], "limit": limits[k]} for k in worst},
            failed)


def _traced(ctx: Context, drv) -> dict:
    cell = ctx.cell
    n_trace = int(cell.cell["trace_steps"])
    records, dtrace, window_s = trace_window(
        lambda: [drv.step() for _ in range(n_trace)], ctx.device)
    counted, syncs, ops = count_work(
        lambda: [drv.step() for _ in range(int(cell.cell["count_steps"]))],
        ctx.device)
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    dev = device_info(ctx.device, cell.chips)
    dev.update(busy_s=dtrace.busy_s, window_s=window_s)
    drv.release()
    read_ctx = {"trace": dtrace, "window_s": window_s, "steps": n_trace,
                "syncs": syncs, "ops": ops,
                "count_steps": int(cell.cell["count_steps"]),
                "program_kernels": program_kernels(),
                "extras": drv.trace_extras(records, counted)}
    metrics = {}
    for m in cell.per_layer:
        value = load_module("metrics", m["name"]).read(read_ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    sample = Reservoir(int(cell.cell["check_samples"]), ctx.rng)
    for rec in records:
        sample.offer(rec)
    checks, failed = _judge(drv, cell, sample.items)
    top = sorted(dtrace.op_s.items(), key=lambda kv: -kv[1])[:10]
    return {"correct": failed == 0, "attempted": n_trace, "failed": failed,
            "metrics": metrics, "device": dev,
            "breakdown": {"device_ops": [[k[:120], v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in dtrace.gaps]},
            "checks": checks}
