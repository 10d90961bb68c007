"""The flagship in mode AFFINE against tpuflow's, on the CPU, and its
recovery of a known rotation and zoom. Split from
tests/test_torch_bm_flow.py, whose frames, settings and tolerances
(FLAGSHIP_ATOL on u, v; labels, winners and time directions equal) it
takes, so that the suite's files spread over its workers; the cases are
unchanged.
"""

import numpy as np
import pytest

import tpuflow.solvers.bm_flow as jb
import tpuflow_torch.solvers.bm_flow as tb
from test_torch_bm_flow import (FLAGSHIP_KW, _assert_outputs_match,  # noqa: F401
                                three_frames)
from tpuflow_torch.core.config import MODE_OUTPUT_AFFINE_BLOCKMATCHING


@pytest.mark.parametrize("normalize", [True, False])
def test_flagship_affine_mode_matches(three_frames, normalize):
    """Mode AFFINE: one per-region affine fit a direction under the real
    BM field, no gated sweep; both pairs equal tpuflow's. The reference's
    step (``affine_normalize_steps=False``) amplifies last-bit differences
    (tests/test_torch_affine.py), so it runs 3 iterations here."""
    f0, f1, f2 = three_frames
    kw = dict(FLAGSHIP_KW, mode=MODE_OUTPUT_AFFINE_BLOCKMATCHING,
              affine_normalize_steps=normalize,
              iter_max=FLAGSHIP_KW["iter_max"] if normalize else 3)
    want1, wstate = jb.optical_flow_block_matching(f0, f1, **kw)
    want2, _ = jb.optical_flow_block_matching(f1, f2, state=wstate, **kw)
    blocks = []
    got1, state = tb.optical_flow_block_matching(f0, f1, device="cpu",
                                                 blocks=blocks, **kw)
    got2, _ = tb.optical_flow_block_matching(f1, f2, state=state,
                                             device="cpu", blocks=blocks,
                                             **kw)
    _assert_outputs_match(got1, want1)
    _assert_outputs_match(got2, want2)
    assert got2.bidirectional and set(np.unique(got2.t)) == {-1, 1}
    assert blocks == [0, 0]


def test_flagship_affine_mode_recovers_rotation_zoom():
    """tests/test_bm_flow.py's ground-truth case through the port: a
    rotation of 0.02 rad and a zoom of 1.01 about the centre, recovered
    to a mean EPE below 1.6 px away from a 16-px border."""
    from scipy.ndimage import gaussian_filter, map_coordinates

    rng = np.random.default_rng(5)
    H, W = 128, 192
    base = gaussian_filter(rng.uniform(0, 255, (H + 40, W + 40, 3)),
                           (3, 3, 0))
    prev = base[20:-20, 20:-20]
    th, s = 0.02, 1.01
    cy, cx = H / 2, W / 2
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    xr = cx + s * np.cos(th) * (xs - cx) - s * np.sin(th) * (ys - cy)
    yr = cy + s * np.sin(th) * (xs - cx) + s * np.cos(th) * (ys - cy)
    nxt = np.stack([map_coordinates(base[..., c], [yr + 20, xr + 20],
                                    order=3) for c in range(3)], -1)
    out, _ = tb.optical_flow_block_matching(
        prev, nxt, 255.0, mode=MODE_OUTPUT_AFFINE_BLOCKMATCHING,
        iter_max=256, search_range=21, kernel_spatial=8, device="cpu")
    m = (slice(16, -16), slice(16, -16))
    epe = float(np.hypot(out.u[m] - (xr - xs)[m],
                         out.v[m] - (yr - ys)[m]).mean())
    assert epe < 1.6
