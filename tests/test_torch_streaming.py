"""tpuflow_torch's frame streams against tpuflow's, on the CPU.

The dense streams: both packages convert frames to float32 (DenseFlow.cpp's
pipeline), so the two run Farneback in float32 and sum its taps in
different orders: tpuflow's CPU path convolves with the 2-D outer
product of the taps, the port runs two separable passes. The flows agree
to 1e-4 x max(1, max|u|) (measured up to 8.6e-6 with |u| <= 2.1 on these
frames); the per-pair math is held exactly by comparing each stream with
its own package's solver.

The feature-tracking stream: tpuflow's converts frames to float64, the
port's to float32 (the sepconv kernel's dtype). On these SyntheticSource
clips both pick the same corners and accept the same tracks; the points
agree to 1e-4 px (measured 2.2e-5 after three tracked frames at |x| <=
160: float32 ulps of the tracking). The flagship stream equals the port's
sequential driver bitwise.
"""

import inspect
import io
import json

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


def test_stream_needs_a_device(monkeypatch):
    """Every stream runs on the card unless told otherwise: without a
    card, a call without ``device`` raises and computes nothing on the
    CPU."""
    for fn in (tst.dense_flow_stream, tst.dense_flow_stream_batched,
               tst.feature_tracking_stream, tst.bm_flow_stream):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    calls = []
    monkeypatch.setattr(tst, "calc_optical_flow_farneback",
                        lambda *a, **k: calls.append(a))
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        list(tst.dense_flow_stream([np.zeros((8, 8))] * 2, None))
    assert calls == []


# -- the feature-tracking stream ----------------------------------------------

PT_ATOL = 1e-4


def _assert_tracks_close(got, want):
    assert len(got) == len(want)
    for (g, pts, prev_pts, acc), (gj, ptsj, prevj, accj) in zip(got, want):
        assert g.dtype == np.float32 and pts.dtype == np.float64
        np.testing.assert_allclose(g, gj, rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(acc, np.asarray(accj))
        np.testing.assert_allclose(pts, ptsj, rtol=0, atol=PT_ATOL)
        np.testing.assert_allclose(prev_pts, prevj, rtol=0, atol=PT_ATOL)


@pytest.mark.parametrize("clip", [
    dict(n_frames=4, h=100, w=140, dx=3.0, dy=1.0, seed=2, max_count=80),
    dict(n_frames=4, h=120, w=160, dx=-2.5, dy=1.5, seed=5, max_count=200)])
def test_feature_tracking_stream_matches_tpuflow(clip):
    clip = dict(clip)
    max_count = clip.pop("max_count")
    frames = list(tst.SyntheticSource(**clip))
    got = list(tst.feature_tracking_stream(frames, max_count=max_count,
                                           device="cpu"))
    want = list(jst.feature_tracking_stream(frames, max_count=max_count))
    _assert_tracks_close(got, want)
    assert len(got) == 3 and all(len(o[1]) > 10 for o in got)
    d = got[-1][1] - got[-1][2]  # tracked points move against the content
    assert abs(np.median(d[:, 0]) + clip["dx"]) < 0.3
    assert abs(np.median(d[:, 1]) + clip["dy"]) < 0.3


def test_feature_tracking_stream_resumes_tpuflow_state():
    """Two frames through tpuflow, the rest through the port from
    ``TrackingState.from_tpuflow``, equal tpuflow's uninterrupted run."""
    frames = list(tst.SyntheticSource(n_frames=4, h=100, w=140, dx=3.0,
                                      dy=-1.0, seed=4))
    want = list(jst.feature_tracking_stream(frames, max_count=80))
    jstate = jst.TrackingState()
    head = list(jst.feature_tracking_stream(frames[:2], max_count=80,
                                            state=jstate))
    state = tst.TrackingState.from_tpuflow(jstate)
    assert state.points is not jstate.points
    np.testing.assert_array_equal(state.points, jstate.points)
    tail = list(tst.feature_tracking_stream(frames[2:], max_count=80,
                                            state=state, device="cpu"))
    _assert_tracks_close(tail, want[1:])
    assert len(head) == 1 and len(state.points) == len(want[-1][1])


def test_feature_tracking_stream_reseeds_static_scene():
    """dx = 0: every track fails the |dx| + |dy| > 2 rule, so the stream
    re-seeds each frame instead of dying, as tpuflow's does."""
    from tpuflow_torch.utils import telemetry

    frames = list(tst.SyntheticSource(n_frames=3, h=80, w=100, dx=0.0,
                                      seed=3))
    events = io.StringIO()
    old = telemetry.get_telemetry()
    telemetry.set_telemetry(telemetry.Telemetry(events))
    try:
        state = tst.TrackingState()
        got = list(tst.feature_tracking_stream(frames, max_count=50,
                                               state=state, device="cpu"))
    finally:
        telemetry.set_telemetry(old)
    want = list(jst.feature_tracking_stream(frames, max_count=50))
    _assert_tracks_close(got, want)
    assert len(got) == 2 and all(len(o[1]) == 0 for o in got)
    assert state.prev_gray is not None
    names = [json.loads(line)["event"]
             for line in events.getvalue().splitlines()]
    # Frame 0 seeds; frame 1 tracks all 50 and keeps none; frame 2
    # re-seeds, then tracks.
    assert names == ["stream.reseed", "stream.track", "stream.reseed",
                     "stream.track"]


# -- the flagship stream ------------------------------------------------------


def test_bm_flow_stream_matches_sequential_driver():
    """tests/test_streaming.py's case: the dispatch-ahead stream equals the
    port's sequential driver over the same frames bitwise, the second
    output onward bidirectional."""
    from scipy.ndimage import gaussian_filter

    from tpuflow_torch.core.config import MODE_OUTPUT_AFFINE_BLOCKMATCHING
    from tpuflow_torch.solvers import optical_flow_block_matching

    rng = np.random.default_rng(3)
    base = gaussian_filter(rng.uniform(0, 255, (44, 72, 3)), (2, 2, 0))
    frames = [base[4 * i : 4 * i + 32, 2 * i : 2 * i + 56]
              for i in range(4)]
    for mode in (0, MODE_OUTPUT_AFFINE_BLOCKMATCHING):
        kw = dict(iter_max=32, search_range=9, kernel_spatial=4,
                  kernel_intensity=0.12, mode=mode)
        stream = list(tst.bm_flow_stream(iter(frames), 255.0, device="cpu",
                                         **kw))
        state, seq = None, []
        for a, b in zip(frames[:-1], frames[1:]):
            out, state = optical_flow_block_matching(a, b, 255.0,
                                                     state=state,
                                                     device="cpu", **kw)
            seq.append(out)
        assert len(stream) == len(seq) == 3
        assert [o.bidirectional for o in stream] == [False, True, True]
        for o_s, o_q in zip(stream, seq):
            for f in ("u", "v", "t", "bm_u", "bm_v"):
                np.testing.assert_array_equal(getattr(o_s, f),
                                              getattr(o_q, f))
