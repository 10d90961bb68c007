"""tpuflow_torch's main program in the HOG modes against tpuflow's, on the
CPU (tests/test_torch_pipeline.py's setting: the port at float64 with
``device="cpu"``, tpuflow under x64, the same files to files):

- the raw HOG files byte for byte;
- the block-normalized HOG within relative 1e-15 (tpuflow's CPU
  ``rsqrt`` is not correctly rounded, tests/test_torch_hog.py);
- the matching vectors' u, v equal, the score within 1e-9 relative (the
  descriptors' last bits), the HOG-compensated frame byte for byte.
"""

import numpy as np
import pytest

import tpuflow.core.config as jcfg
from test_torch_pipeline import _motion_frames, _opts, _run_both, _same_bytes
from tpuflow_torch.core import io as tio

HOG_RTOL = 1e-15
SCORE_RTOL = 1e-9


@pytest.mark.parametrize("dense", [True, False])
def test_hog_modes(tmp_path, dense):
    pattern = _motion_frames(tmp_path, n=2)
    for mode, tag in ((jcfg.MODE_OUTPUT_HOG_RAW, "raw"),
                      (jcfg.MODE_OUTPUT_HOG, "block")):
        opts = _opts(mode=mode)
        opts.hog_param.dense = dense
        sub = tmp_path / tag
        sub.mkdir()
        j, t, names = _run_both(sub, pattern, "h_%04d.bin", opts, end=1)
        for name in names:
            jh, js = tio.read_hog(j / name)
            th, ts = tio.read_hog(t / name)
            assert ts == js and th.shape == jh.shape
            if tag == "raw":
                assert (t / name).read_bytes() == (j / name).read_bytes()
            else:
                np.testing.assert_allclose(th, jh, rtol=HOG_RTOL, atol=0)


@pytest.mark.parametrize("dense", [True, False])
def test_hog_matching_mode(tmp_path, dense):
    # The dense grid at tests/test_pipeline.py's 30x40; the cell grid
    # needs 72x96 for its block normalization.
    pattern = _motion_frames(tmp_path, n=2, h=30 if dense else 72,
                             w=40 if dense else 96)
    opts = _opts(mode=jcfg.MODE_OUTPUT_HOG_MATCHING_VECTOR)
    opts.hog_param.dense = dense
    j, t, names = _run_both(tmp_path, pattern, "hv_%04d.bin", opts, end=1)
    assert names == ["hv_0001.bin", "hv_0001compensated.bin"]
    ju, jv, js = tio.read_flow(j / "hv_0001.bin", components=3)
    tu, tv, ts = tio.read_flow(t / "hv_0001.bin", components=3)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(ts, js, rtol=SCORE_RTOL, atol=0)
    if dense:  # the frames move by (-2, -2)
        assert ((tu == -2) & (tv == -2))[4:-4, 4:-4].mean() > 0.5
    _same_bytes(j, t, ["hv_0001compensated.bin"])
