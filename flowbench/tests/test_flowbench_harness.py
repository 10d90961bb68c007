"""The harness is driven by data: a cell, a configuration or a metric is
added as files and BENCHMARK.json entries; nothing it runs imports JAX or
the JAX package, and the references import nothing of the program."""

import importlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _modules():
    root = REPO / "flowbench"
    return sorted("flowbench." + ".".join(p.relative_to(root).with_suffix("")
                                          .parts)
                  for p in root.rglob("*.py")
                  if "tests" not in p.parts and p.name != "__init__.py")


def _run(code: str, cwd: Path) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_benchmark_json_names_and_files():
    names = [c["name"] for c in BENCH["configs"]] + [
        w["name"] for w in BENCH["workloads"]] + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (REPO / "flowbench" / "cells" / f"{w['name']}.json").is_file()
        assert (REPO / "flowbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    assert [m["name"] for m in BENCH["end_to_end"]] == [
        "frames_per_s", "frame_ms_p95", "setup_s"]


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_states_its_entry(metric):
    mod = importlib.import_module(f"flowbench.metrics.{metric['name']}")
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (
        metric["layer"], metric["unit"], metric["moves"])


def test_new_cell_config_and_metric_are_only_files(tmp_path):
    """A copy of the benchmark with a new configuration, traffic mix, cell
    and metric added as files and entries, no file edited: the harness
    lists and loads them."""
    shutil.copytree(REPO / "flowbench", tmp_path / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    fb = tmp_path / "flowbench"
    cfg = json.loads((fb / "configs" / "kitti_black_anandan.json")
                     .read_text())
    cfg["level"] = 3
    (fb / "configs" / "small_ba.json").write_text(json.dumps(cfg))
    (fb / "traffic" / "texture_pairs_two.json").write_text(json.dumps(
        {"generator": "texture_pairs", "sigma": 2.0,
         "shifts": [[1, 0], [0, -1]]}))
    (fb / "cells" / "ba_small.json").write_text(
        (fb / "cells" / "ba_kitti_pairs.json").read_text())
    (fb / "metrics" / "frames_traced.py").write_text(
        'LAYER = "device: one H100"\nUNIT = "frames"\n'
        'MOVES = "frames_per_s"\n\n\ndef read(ctx):\n'
        '    return ctx["steps"]\n')
    bench["configs"].append({"name": "small_ba", "source": "test",
                             "file": "flowbench/configs/small_ba.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "ba_small", "config": "small_ba",
                               "traffic": "texture_pairs_two", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({
        "name": "frames_traced", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "device: one H100",
        "moves": "frames_per_s", "workloads": ["ba_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run(
        "import json\n"
        "from flowbench import harness\n"
        "c = harness.Cell.load('ba_small')\n"
        "m = harness.load_module('metrics', 'frames_traced')\n"
        "print(json.dumps([c.config['level'], len(c.traffic['shifts']),\n"
        "    [x['name'] for x in c.per_layer], m.read({'steps': 4}),\n"
        "    harness.__file__]))\n", tmp_path)
    level, pairs, metrics, read, where = json.loads(out)
    assert (level, pairs, read) == (3, 2, 4)
    assert "frames_traced" in metrics
    assert Path(where).resolve().is_relative_to(tmp_path.resolve())


def test_nothing_imports_jax_or_the_jax_package():
    """Every module of the benchmark, and the port's entry points the
    drivers call, leave no ``jax``, ``jaxlib``, ``flax`` or ``tpuflow``
    top-level module loaded (names compared whole)."""
    mods = _modules() + ["tpuflow_torch.pipeline.streaming",
                         "tpuflow_torch.solvers.black_anandan_fast",
                         "tpuflow_torch.utils.telemetry",
                         "tpuflow_torch.core.config"]
    out = _run("import importlib, json, sys\n"
               f"for m in {mods!r}:\n"
               "    importlib.import_module(m)\n"
               "from flowbench import harness\n"
               "print(json.dumps(harness.forbidden_modules()))\n", REPO)
    assert json.loads(out) == []


def test_references_import_nothing_of_the_program():
    refs = [m for m in _modules() if ".reference." in m]
    assert refs
    out = _run("import importlib, json, sys\n"
               f"for m in {refs!r}:\n"
               "    importlib.import_module(m)\n"
               "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules"
               " if k.split('.')[0] in ('tpuflow_torch', 'tpuflow', 'jax')})))"
               "\n", REPO)
    assert json.loads(out) == []


def test_forbidden_names_compare_whole(monkeypatch):
    from flowbench import harness

    monkeypatch.setitem(sys.modules, "tpuflow_torch_x", sys)
    assert "tpuflow" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpuflow.solvers", sys)
    assert "tpuflow" in harness.forbidden_modules()


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "flowbench/run.py", "--workload",
                          "ba_kitti_pairs", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_reservoir_is_uniform_and_seeded():
    import numpy as np

    from flowbench.harness import Reservoir

    def draw(seed):
        r = Reservoir(3, np.random.default_rng(seed))
        for i in range(100):
            r.offer(i)
        return sorted(r.items)

    assert draw(1) == draw(1)
    counts = np.zeros(100)
    for s in range(2000):
        counts[draw(s)] += 1
    assert counts.min() > 20 and counts.max() < 110
