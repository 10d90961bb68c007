"""tpuflow_torch's dense frame streams against tpuflow's, on the CPU.

Both packages' streams convert frames to float32 (DenseFlow.cpp's
pipeline), so the two run Farneback in float32 and sum its taps in
different orders: tpuflow's CPU path convolves with the 2-D outer
product of the taps, the port runs two separable passes. The flows agree
to 1e-4 x max(1, max|u|) (measured up to 8.6e-6 with |u| <= 2.1 on these
frames); the per-pair math is held exactly by comparing each stream with
its own package's solver.
"""

import numpy as np
import pytest
import torch

from tpuflow.pipeline import streaming as jst
from tpuflow_torch.pipeline import streaming as tst
from tpuflow_torch.solvers import calc_optical_flow_farneback

# Reduced from the demo's 640x480 working size and 48-px window.
CFG = dict(pyr_scale=0.5, levels=2, winsize=15, iterations=2, poly_n=5,
           poly_sigma=1.2)
ATOL_F32 = 1e-4


def _assert_flow_close(got, ref):
    bound = ATOL_F32 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=bound)


def test_synthetic_source_frames_equal():
    a = list(tst.SyntheticSource(n_frames=3, h=20, w=30, dx=1.5, dy=0.5))
    b = list(jst.SyntheticSource(n_frames=3, h=20, w=30, dx=1.5, dy=0.5))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("warm", [False, True])
def test_dense_flow_stream_matches_tpuflow(warm):
    """Gray frames resized by zero-order hold (56x40 -> 48x36), with and
    without the previous flow as the initial flow."""
    def frames():
        src = tst.SyntheticSource(n_frames=4, h=40, w=56, dx=2.0, dy=1.0)
        for f in src:  # RGB frames exercise rgb_to_gray
            yield np.repeat(f[..., None], 3, axis=-1)

    got = list(tst.dense_flow_stream(frames(), (48, 36), **CFG,
                                     warm_start_flow=warm, device="cpu"))
    ref = list(jst.dense_flow_stream(frames(), (48, 36), **CFG,
                                     warm_start_flow=warm))
    assert len(got) == len(ref) == 3
    for (g, u, v), (gj, uj, vj) in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == (36, 48)
        np.testing.assert_allclose(g, gj, rtol=1e-6, atol=1e-4)
        _assert_flow_close(u, uj)
        _assert_flow_close(v, vj)
    # The stream is the solver on consecutive gray frames, seeded with
    # the previous flow when warm.
    init = tuple(torch.from_numpy(f) for f in got[0][1:])
    u1, _ = calc_optical_flow_farneback(
        torch.from_numpy(got[0][0]), torch.from_numpy(got[1][0]), init,
        *CFG.values(), flags=0x100 if warm else 0)
    assert np.array_equal(u1.numpy(), got[1][1])


def test_dense_flow_stream_carries_state():
    """A stream resumed from its state equals one uninterrupted stream."""
    clip = list(tst.SyntheticSource(n_frames=4, h=32, w=40, dx=1.0))
    full = list(tst.dense_flow_stream(clip, None, **CFG, device="cpu"))
    state = tst.DenseStreamState()
    first = list(tst.dense_flow_stream(clip[:2], None, **CFG, state=state,
                                       device="cpu"))
    rest = list(tst.dense_flow_stream(clip[2:], None, **CFG, state=state,
                                      device="cpu"))
    assert len(first) + len(rest) == len(full) == 3
    for (_, u, v), (_, uf, vf) in zip(first + rest, full):
        assert np.array_equal(u, uf) and np.array_equal(v, vf)


def test_dense_flow_stream_batched_matches_tpuflow():
    clip = np.stack(list(tst.SyntheticSource(n_frames=4, h=36, w=44,
                                             dx=1.5)))
    us, vs = tst.dense_flow_stream_batched(clip, **CFG, device="cpu")
    uj, vj = jst.dense_flow_stream_batched(clip, **CFG)
    assert us.shape == (3, 36, 44) and us.dtype == torch.float32
    _assert_flow_close(us.numpy(), uj)
    _assert_flow_close(vs.numpy(), vj)
    # Each pair equals the generator's.
    gen = list(tst.dense_flow_stream(clip, None, **CFG, device="cpu"))
    for t, (_, u, v) in enumerate(gen):
        assert np.array_equal(us[t].numpy(), u)
        assert np.array_equal(vs[t].numpy(), v)


def test_stream_needs_a_device():
    with pytest.raises(TypeError):
        list(tst.dense_flow_stream([np.zeros((8, 8))] * 2, None))
