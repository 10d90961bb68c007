"""``Options.devices``: tpuflow_torch's main program with the flagship on a
mesh of spawned gloo CPU ranks (once per ``run_pipeline``), against the
single-device run of the same frames (tests/test_torch_pipeline_bm.py's
scene and settings).

Every rank runs the frame loop and its digests must agree frame by
frame (a disagreement raises); rank 0 writes. One rank gives the
single-device files byte for byte; two ranks (a 1x2 mesh: the search
candidate-parallel, the refine tiled) the same file names, the same
segmentation PGMs and flows within 1e-6 (the sharded flagship's bound,
tests/test_torch_bm_mesh_driver.py). The CLI's ``--devices`` lands in
``Options.devices``.
"""

import numpy as np
import pytest
import torch

import tpuflow.core.config as jcfg
from test_torch_pipeline_bm import (FLOW_ATOL, SHIFT_ATOL, _flows, _frames,
                                    _opts)
from tpuflow_torch.cli.parser import build_parser, parse_args_to_options
from tpuflow_torch.core.config import from_tpuflow
from tpuflow_torch.pipeline import orchestrator as torch_orch


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    pattern = _frames(root)
    folder = root / "single"
    folder.mkdir()
    torch_orch.run_pipeline(
        pattern, str(folder / "of_%04d.dat"), 0, 2,
        from_tpuflow(_opts(jcfg.MODE_OUTPUT_OPTICALFLOW_BLOCKMATCHING)),
        device="cpu", dtype=torch.float64)
    return pattern, folder


@pytest.mark.parametrize("devices", [1, 2])
def test_mesh_run(tmp_path, single, devices):
    pattern, t = single
    opts = _opts(jcfg.MODE_OUTPUT_OPTICALFLOW_BLOCKMATCHING, devices)
    state = torch_orch.run_pipeline(pattern, str(tmp_path / "of_%04d.dat"),
                                    0, 2, from_tpuflow(opts), device="cpu",
                                    dtype=torch.float64)
    assert len(state.bm_state.lab_frames) == 3
    assert state.bm_state.lab_frames[0].device.type == "cpu"
    names = sorted(p.name for p in t.iterdir())
    assert names == sorted(p.name for p in tmp_path.iterdir())
    for name in names:
        if devices == 1 or name.endswith("segmentation_.dat.pgm"):
            assert (tmp_path / name).read_bytes() == (t / name).read_bytes()
    got, want = _flows(tmp_path), _flows(t)
    for name in want:
        tol = SHIFT_ATOL if "shift-vector" in name else FLOW_ATOL
        for a, b in zip(got[name], want[name]):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def test_devices_option():
    args = build_parser().parse_args(["-i", "x", "-o", "y", "--devices",
                                      "4"])
    assert parse_args_to_options(args).devices == 4
