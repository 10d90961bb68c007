"""tpuflow_torch's command line against tpuflow's.

- Every option of tpuflow's parser exists with the same destination and
  default, plus ``--device`` (default ``cuda``).
- ``parse_args_to_options`` gives, for tests/test_pipeline.py's option
  sets and more, the port's ``Options`` equal to tpuflow's carried over
  by ``from_tpuflow`` (nested params included).
- ``main`` and ``python -m tpuflow_torch.cli`` run the pipeline on the
  CPU with ``--device cpu`` and write what tpuflow's CLI writes (the
  scratch plot byte for byte); ``--telemetry`` turns on the port's
  telemetry (JSON lines on stderr).
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpuflow.cli import parser as jparser
from tpuflow_torch.cli import parser as tparser
from tpuflow_torch.core import io as tio
from tpuflow_torch.core.config import Options, from_tpuflow

REPO = Path(__file__).resolve().parent.parent

ARGV_SETS = {
    "defaults": [],
    "bm": ["--opticalflow_blockmatching", "--mm_level", "3",
           "--filter_type", "gaussian", "--gauss_var", "2.5", "-n",
           "--exclusive", "--superimpose", "red", "--epsilon", "0.5", "-l",
           "9", "--resample", "64x48", "--resample_method", "bicubic",
           "--HOG_bins", "8", "--HOG_unsigned"],
    "gauss_stddev": ["--filter_type", "gaussian", "--gauss_stddev", "7.5",
                     "--debug_dumps"],
    "refine_warp": ["--opticalflow_blockmatching", "--refine_warp"],
    "turbo": ["--opticalflow_blockmatching", "--bm_profile", "turbo"],
    "bf16_mesh": ["--affine_blockmatching", "--bm_precision", "bf16",
                  "--devices", "4", "--checkpoint", "c.pkl", "--telemetry"],
    "hog": ["--HOG_matching_vector", "--HOG_less_densely", "--HOG_signed",
            "--HOG_raw", "--HOG"],
    "scratch": ["--binary", "--filter_type", "Epsilon", "--filter_size",
                "9x7", "--filter_ep", "12", "--s_med", "4", "--s_avg", "15",
                "-L", "30", "--exclusive_rad", "2.5", "--x11_plot",
                "--plot_as_resampled", "--plot_resampled_only"],
    "filtered_affine": ["--filtered", "--multiple_affine",
                        "--superimpose", "blue"],
}


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default)
            for a in parser._actions if a.dest != "help"}


def test_same_options_plus_device():
    j = _actions(jparser.build_parser())
    t = _actions(tparser.build_parser())
    assert t.pop("device") == (("--device",), "cuda")
    assert t == j
    assert len(t) >= 40


@pytest.mark.parametrize("name", sorted(ARGV_SETS))
def test_parse_args_to_options(name):
    argv = ["-i", "in_%04d.pgm", "-o", "out_%04d.pgm"] + ARGV_SETS[name]
    want = jparser.parse_args_to_options(
        jparser.build_parser().parse_args(argv))
    got = tparser.parse_args_to_options(
        tparser.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert type(got) is Options
    assert dataclasses.asdict(got) == dataclasses.asdict(from_tpuflow(want))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "bf16_mesh":
        assert got.multiple_motion_param.bm_method == "matmul_bf16"
        assert got.devices == 4


def _frames(folder, n=2, h=40, w=56):
    rng = np.random.default_rng(0)
    for i in range(n):
        img = np.full((h, w), 100.0) + rng.normal(0, 0.5, (h, w))
        img[:, 28] += 40
        tio.write_pnm(folder / f"in_{i:04d}.pgm", img.astype(np.uint8))
    return str(folder / "in_%04d.pgm")


def test_main_matches_tpuflow_cli(tmp_path):
    pattern = _frames(tmp_path)
    for pkg, main, extra in (("j", jparser.main, []),
                             ("t", tparser.main, ["--device", "cpu"])):
        rc = main(["-i", pattern, "-o", str(tmp_path / f"{pkg}_%04d.pgm"),
                   "-s", "0", "-e", "1", "--exclusive"] + extra)
        assert rc == 0
    for num in range(2):
        assert (tmp_path / f"t_{num:04d}.pgm").read_bytes() == \
            (tmp_path / f"j_{num:04d}.pgm").read_bytes()


def test_main_requires_input_and_output():
    with pytest.raises(SystemExit):
        tparser.main(["-i", "x"])


def test_python_m_runs_on_cpu_with_telemetry(tmp_path):
    pattern = _frames(tmp_path, n=1)
    proc = subprocess.run(
        [sys.executable, "-m", "tpuflow_torch.cli", "-i", pattern, "-o",
         str(tmp_path / "o_%04d.pgm"), "--binary", "--telemetry",
         "--device", "cpu", "--checkpoint", str(tmp_path / "ck.pkl")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out, _ = tio.read_pnm(tmp_path / "o_0000.pgm")
    assert (out[:, 28] == 255).all()
    events = [json.loads(ln) for ln in proc.stderr.splitlines()
              if ln.startswith("{")]
    assert any(e.get("event") == "pipeline.frame" for e in events), \
        proc.stderr
    assert (tmp_path / "ck.pkl").exists()
