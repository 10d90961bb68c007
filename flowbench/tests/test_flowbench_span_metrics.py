"""The metrics read from the program's spans: a traced CPU run of each cell
reads the host's wait and busy time a frame, which the traced frame time
closes over; each reader reads nothing from a program that records no
spans."""

import importlib
import json
from pathlib import Path

import pytest

from flowbench import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SEED = 2**31 + 1231
SPAN_METRICS = ["host_wait_ms_per_frame", "host_busy_ms_per_frame",
                "bm_search_host_ms_per_frame"]


def _crop(name):
    """The cell at a CPU crop, two frames traced and one counted; the
    flagship's search over 15 x 15 candidates and 130 refine sweeps, BA's
    levels capped at 32 sweeps."""
    ov = {"config": {"frame_shape": [48, 80]},
          "cell": {"trace_steps": 2, "count_steps": 1}}
    if name.startswith("flagship"):
        ov["traffic"] = {"pool_frames": 6, "walk_margin": [6, 12]}
        ov["config"].update(kernel_spatial=5, search_range=15,
                            iter_max=130)
    else:
        ov["config"]["iter_max"] = 32
    return ov


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_traced_cpu_run_reads_the_host_from_spans(name):
    res = harness.run(name, SEED, 0.5, True, device="cpu",
                      overrides=_crop(name))
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    wait, busy = m["host_wait_ms_per_frame"], m["host_busy_ms_per_frame"]
    assert wait >= 0.0 and busy > 0.0
    # The spans cover the program's part of each traced frame.
    frame_ms = 1e3 * res["device"]["window_s"] / res["attempted"]
    assert wait + busy <= frame_ms
    if name.startswith("flagship"):
        assert m["bm_search_host_ms_per_frame"] > 0.0


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_reader_reads_nothing_without_spans(metric, monkeypatch):
    from tpuflow_torch.utils import telemetry

    mod = importlib.import_module(f"flowbench.metrics.{metric}")
    ctx = {"steps": 2}
    monkeypatch.setattr(telemetry, "spans", lambda: [])
    assert mod.read(ctx) is None
    monkeypatch.delattr(telemetry, "spans")  # a program with no tracer
    assert mod.read(ctx) is None
