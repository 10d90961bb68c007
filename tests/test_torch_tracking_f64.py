"""The feature-tracking stream at float64 against tpuflow's, on the CPU.

tpuflow's stream converts frames to float64; the port's takes the dtype
it is given (float32 by default, the sepconv kernel's dtype on the
card). At ``dtype=torch.float64`` the two run the same float64 stream:
the gray frames agree to 1e-12, the same corners are seeded and the same
tracks accepted, and the tracked points agree to 1e-9 px, the bound
``track_points`` is held to (tests/test_torch_lucas_kanade.py).
"""

import numpy as np
import pytest
import torch

from tpuflow.pipeline import streaming as jst
from tpuflow_torch.pipeline import streaming as tst

PT_ATOL = 1e-9


@pytest.mark.parametrize("clip", [
    dict(n_frames=4, h=100, w=140, dx=3.0, dy=1.0, seed=2, max_count=80),
    dict(n_frames=4, h=120, w=160, dx=-2.5, dy=1.5, seed=5, max_count=200)])
def test_feature_tracking_stream_float64_matches_tpuflow(clip):
    clip = dict(clip)
    max_count = clip.pop("max_count")
    frames = list(tst.SyntheticSource(**clip))
    got = list(tst.feature_tracking_stream(frames, max_count=max_count,
                                           device="cpu",
                                           dtype=torch.float64))
    want = list(jst.feature_tracking_stream(frames, max_count=max_count))
    assert len(got) == len(want) == 3
    for (g, pts, prev_pts, acc), (gj, ptsj, prevj, accj) in zip(got, want):
        assert g.dtype == np.float64 and pts.dtype == np.float64
        np.testing.assert_allclose(g, gj, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(acc, np.asarray(accj))
        np.testing.assert_allclose(pts, ptsj, rtol=0, atol=PT_ATOL)
        np.testing.assert_allclose(prev_pts, prevj, rtol=0, atol=PT_ATOL)
    assert all(len(o[1]) > 10 for o in got)
