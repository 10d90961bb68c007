"""The flagship's modes of tpuflow_torch's main program against tpuflow's,
on the CPU, and the pipeline state's checkpoint, resume and mesh run.

tpuflow's own small settings (tests/test_pipeline.py: 40 refine
iterations, search 7, mean-shift kernel 5) over three 36x48 frames
moving 2 px a frame. The flagship runs in float32 in both packages, so
(tests/test_torch_bm_flow.py) the labels, region counts and BM winners
are equal and u, v agree within 1e-6; here that shows as: the same file
names (the middle frame's flow under the previous name), segmentation
PGMs and colour-quantized PPMs byte for byte, flow files within 1e-6
and shift-vector files within 1e-4, and each compensated frame equal to
the port's own compensation of the flow it wrote.

A state saved after frame 1 and loaded, and one carried over from
tpuflow's run (``PipelineState.from_tpuflow``), resume frame 2 to the
files of the uninterrupted run (byte for byte, and within the bounds
above from tpuflow's state). The mesh run is in
tests/test_torch_pipeline_mesh.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import voronoi_frames
import tpuflow.core.config as jcfg
from tpuflow.pipeline import orchestrator as jorch
from tpuflow_torch.core import io as tio
from tpuflow_torch.core.config import from_tpuflow
from tpuflow_torch.pipeline import orchestrator as torch_orch
from tpuflow_torch.pipeline.motion_compensation import compensate

FLOW_ATOL = 1e-6
SHIFT_ATOL = 1e-4  # tests/test_torch_bm_flow.py's bound
H, W = 40, 56
SEG_R = 8


def _frames(folder: Path):
    """tests/test_torch_bm_flow.py's scene (seed 7: rounded to 8 bits,
    seed 1's third frame leaves the contract): chip_smoke's pan over
    shaded Voronoi cells at 40x56, (1, 2) px a frame, as PPM files; every
    frame within the mean-shift filter's drift contract, where the port's
    filter and tpuflow's default one agree."""
    import jax.numpy as jnp

    from tpuflow.core.color import srgb_to_lab
    from tpuflow.segmentation.meanshift import mean_shift_filter

    frames, _ = voronoi_frames((H, W), cells_per_px=150 / (56 * 72),
                               pan=(1, 2), shade=1.875, seed=7)
    for i, f in enumerate(frames):
        f = np.rint(f).astype(np.uint8)
        lab = srgb_to_lab(jnp.asarray(f, jnp.float32) / 255.0)
        drift = mean_shift_filter(lab, SEG_R, 16 / 255.0, 8,
                                  with_drift=True)[2]
        assert float(drift) <= SEG_R
        tio.write_pnm(folder / f"in_{i:04d}.ppm", f)
    return str(folder / "in_%04d.ppm")


def _opts(mode, devices=0):
    opts = jcfg.Options()
    opts.mode = mode
    opts.devices = devices
    mm = opts.multiple_motion_param
    mm.irls_iter_max = 40
    mm.bm_search_range = 7
    mm.bm_kernel_spatial = SEG_R
    return opts


def _port(pattern, out, opts, start=0, end=2, state=None):
    return torch_orch.run_pipeline(pattern, out, start, end,
                                   from_tpuflow(opts), state=state,
                                   device="cpu", dtype=torch.float64)


def _flows(folder):
    return {p.name: tio.read_flow(p) for p in folder.iterdir()
            if p.suffix == ".dat"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """tpuflow and the port over the three frames, in both modes."""
    root = tmp_path_factory.mktemp("bm")
    pattern = _frames(root)
    out = {}
    for mode, tag in ((jcfg.MODE_OUTPUT_OPTICALFLOW_BLOCKMATCHING, "of"),
                      (jcfg.MODE_OUTPUT_AFFINE_BLOCKMATCHING, "af")):
        for pkg in ("j", "t"):
            folder = root / f"{pkg}_{tag}"
            folder.mkdir()
            if pkg == "j":
                state = jorch.run_pipeline(pattern, str(folder / "of_%04d.dat"),
                                           0, 2, _opts(mode))
            else:
                state = _port(pattern, str(folder / "of_%04d.dat"),
                              _opts(mode))
            out[(pkg, tag)] = (folder, state)
    return pattern, out


@pytest.mark.parametrize("tag", ["of", "af"])
def test_flagship_modes_match_tpuflow(runs, tag):
    pattern, out = runs
    (j, _), (t, state) = out[("j", tag)], out[("t", tag)]
    names = sorted(p.name for p in j.iterdir())
    assert names == sorted(p.name for p in t.iterdir())
    # The middle frame's flow goes under the previous frame's name.
    assert "of_0001.dat" in names and "of_0002.dat" not in names
    for name in names:
        if name.endswith((".pgm", ".ppm")) and "compensated" not in name:
            assert (t / name).read_bytes() == (j / name).read_bytes(), name
    jf, tf = _flows(j), _flows(t)
    assert sorted(jf) == sorted(tf) and len(tf) == 3
    for name in tf:
        tol = SHIFT_ATOL if "shift-vector" in name else FLOW_ATOL
        for a, b in zip(tf[name], jf[name]):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)
    u, v = tf["of_0001.dat"]
    assert np.abs(u).max() > 0.5
    assert len(state.bm_state.lab_frames) == 3


def test_compensated_frame_is_the_ports_compensation(tmp_path):
    pattern = _frames(tmp_path)
    opts = _opts(jcfg.MODE_OUTPUT_OPTICALFLOW_BLOCKMATCHING)
    results = {}
    state = torch_orch.PipelineState()
    for num in range(2):
        frame, maxint = tio.read_image(pattern.replace("%04d", f"{num:04d}"))
        res, state = torch_orch.process_frame(
            frame.astype(np.float64), maxint, from_tpuflow(opts),
            str(tmp_path / f"of_{num:04d}.dat"), state, device="cpu",
            dtype=torch.float64)
        results[num] = res
    flow = results[1]["flow"]
    # The flow as the flagship returns it (float32), as tpuflow passes it.
    want = compensate(torch.from_numpy(state.prev_gray2),
                      torch.from_numpy(flow.u), torch.from_numpy(flow.v)
                      ).numpy()
    tio.write_pnm(tmp_path / "want.pgm", want, 255)
    assert (tmp_path / "compensated_of_0001.dat.pgm").read_bytes() == \
        (tmp_path / "want.pgm").read_bytes()


def test_state_save_load_resumes(tmp_path, runs):
    pattern, out = runs
    folder = tmp_path / "resume"
    folder.mkdir()
    opts = _opts(jcfg.MODE_OUTPUT_OPTICALFLOW_BLOCKMATCHING)
    state = _port(pattern, str(folder / "of_%04d.dat"), opts, 0, 1)
    state.save(tmp_path / "ckpt.pkl")
    back = torch_orch.PipelineState.load(tmp_path / "ckpt.pkl", "cpu")
    assert back.frame_size == state.frame_size
    _port(pattern, str(folder / "of_%04d.dat"), opts, 2, 2, state=back)
    t, _ = out[("t", "of")]
    for name in sorted(p.name for p in t.iterdir()):
        assert (folder / name).read_bytes() == (t / name).read_bytes(), name


def test_from_tpuflow_state_resumes(tmp_path, runs):
    """tpuflow runs frames 0-1 into the folder, the port resumes frame 2
    there from tpuflow's state (whose previous output name points into
    the folder): the middle frame's flow and frame 2's side outputs match
    the port's uninterrupted run."""
    pattern, out = runs
    opts = _opts(jcfg.MODE_OUTPUT_OPTICALFLOW_BLOCKMATCHING)
    jstate = jorch.run_pipeline(pattern, str(tmp_path / "of_%04d.dat"), 0,
                                1, opts)
    state = torch_orch.PipelineState.from_tpuflow(jstate, "cpu")
    assert isinstance(state.bm_state.lab_frames[0], torch.Tensor)
    _port(pattern, str(tmp_path / "of_%04d.dat"), opts, 2, 2, state=state)
    t, _ = out[("t", "of")]
    got, want = _flows(tmp_path), _flows(t)
    assert sorted(got) == sorted(want)
    for name in got:
        tol = SHIFT_ATOL if "shift-vector" in name else FLOW_ATOL
        for a, b in zip(got[name], want[name]):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)
    assert (tmp_path / "of_0002segmentation_.dat.pgm").read_bytes() == \
        (t / "of_0002segmentation_.dat.pgm").read_bytes()
