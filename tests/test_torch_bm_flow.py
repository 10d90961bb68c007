"""tpuflow_torch's flagship block-matching flow against tpuflow, on the CPU.

The region-gated IRLS sweep: the port's plain version (CPU tensors) vs
tpuflow's Pallas kernel in interpret mode, and the three refine loops vs
tpuflow's, in float64: the same operations in the same order, so the
fields agree to atol 1e-12 (tpuflow's own bound between its kernel and
jnp loop), the energy traces to rtol 1e-10 (float64 sums in another
order). The flagship runs in float32 in both packages (tpuflow casts the
frames to float32); there the one-hot sums of the search differ in the
last bits between XLA and PyTorch, so the frames have clear minima and
the winners, labels and time directions must be equal, and u, v agree to
1e-6 (a few float32 ulps of the refinement), in the default mode and in
mode AFFINE (measured 2.4e-7 there: tpuflow sums the regions' affine
moments in float32, the port in float64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import voronoi_frames
import tpuflow.solvers.bm_flow as jb
from tpuflow.core.color import srgb_to_lab as j_srgb_to_lab
from tpuflow.kernels.irls_stencil import irls_gated_sweep_pallas
from tpuflow.pipeline import metrics as jmetrics
from tpuflow.pipeline.motion_compensation import compensate as j_compensate
from tpuflow.segmentation.meanshift import mean_shift_filter as j_ms_filter
import tpuflow_torch.solvers.bm_flow as tb
from tpuflow_torch.core.config import MultipleMotionParam
from tpuflow_torch.kernels import irls_stencil
from tpuflow_torch.pipeline import metrics as tmetrics
from tpuflow_torch.pipeline.motion_compensation import compensate
from tpuflow_torch.utils.numerics import warm_cpu_sqrt
from tpuflow_torch.utils.telemetry import EnergyTrace

ARGS = (5.0, 1.0, 0.14, 0.02)  # lambda_d, lambda_s, sigma_d, sigma_s
FIELD_ATOL = 1e-12
TRACE_RTOL = 1e-10
# The flagship in float32 (see the module docstring).
FLAGSHIP_ATOL = 1e-6
warm_cpu_sqrt()  # the coherence weights' sqrt is held to FIELD_ATOL


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, atol=FIELD_ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def gated_fields():
    """tests/test_bm_flow.py:175-202's fields, 40x70 (not tile-aligned)."""
    rng = np.random.default_rng(7)
    h, w = 40, 70
    gx, gy = rng.normal(size=(h, w)), rng.normal(size=(h, w))
    it = 0.3 * rng.normal(size=(h, w))
    labels = rng.integers(0, 5, (h, w)).astype(np.int32)
    u0, v0 = 0.2 * rng.normal(size=(h, w)), 0.2 * rng.normal(size=(h, w))
    return gx, gy, it, labels, u0, v0


@pytest.fixture(scope="module")
def stop_fields():
    """tests/test_bm_flow.py:204-241: element 0's tiny dt stops it at the
    first check against the loose threshold; element 1 runs on."""
    rng = np.random.default_rng(11)
    h, w = 32, 48
    gx, gy = rng.normal(size=(h, w)), rng.normal(size=(h, w))
    it0 = 1e-4 * rng.normal(size=(h, w))
    it1 = 0.5 * rng.normal(size=(h, w))
    labels = rng.integers(0, 4, (h, w)).astype(np.int32)
    return gx, gy, np.stack([it0, it1]), labels


@pytest.mark.parametrize("n,fuse", [(20, 8), (7, 16), (3, 1)])
def test_gated_plain_matches_pallas_interpret(gated_fields, n, fuse):
    gx, gy, it, labels, u0, v0 = gated_fields
    sup = jb._gated_sup(*_j(gx, gy), *ARGS)
    want = irls_gated_sweep_pallas(*_j(u0, v0, gx, gy, it),
                                   jnp.asarray(labels, jnp.float64), *sup, n,
                                   *ARGS, tile_h=16, tile_w=128, fuse=fuse,
                                   interpret=True)
    sup_t = tb._gated_sup(*_t(gx, gy), *ARGS)
    got = irls_stencil.irls_gated_sweeps(*_t(u0, v0, gx, gy, it, labels),
                                         *sup_t, n, *ARGS)
    for a, b in zip(got, want):
        _close(a, b)


def test_gated_batch_is_per_element(gated_fields):
    """A (2, H, W) batch equals two (H, W) calls (shared gx/gy/labels)."""
    gx, gy, it, labels, u0, v0 = gated_fields
    gx_t, gy_t, it_t, lab_t, u_t, v_t = _t(gx, gy, it, labels, u0, v0)
    sup = tb._gated_sup(gx_t, gy_t, *ARGS)
    its = torch.stack([it_t, -it_t])
    us, vs = torch.stack([u_t, v_t]), torch.stack([v_t, u_t])
    ub, vb = irls_stencil.irls_gated_sweeps(us, vs, gx_t, gy_t, its, lab_t,
                                            *sup, 5, *ARGS)
    for b in range(2):
        u1, v1 = irls_stencil.irls_gated_sweeps(us[b], vs[b], gx_t, gy_t,
                                                its[b], lab_t, *sup, 5, *ARGS)
        torch.testing.assert_close(ub[b], u1, rtol=0, atol=0)
        torch.testing.assert_close(vb[b], v1, rtol=0, atol=0)


def test_gated_wrapper_rejects(gated_fields):
    gx, gy, it, labels, u0, v0 = _t(*gated_fields)
    sup = tb._gated_sup(gx, gy, *ARGS)
    with pytest.raises(ValueError, match="share"):
        irls_stencil.irls_gated_sweeps(u0[:-1], v0, gx, gy, it, labels, *sup,
                                       1, *ARGS)
    with pytest.raises(ValueError, match="fuse"):
        irls_stencil.irls_gated_sweeps(u0, v0, gx, gy, it, labels, *sup, 0,
                                       *ARGS)
    with pytest.raises(ValueError, match="one-element"):
        irls_stencil.irls_gated_sweeps(u0, v0, gx, gy, it, labels, gx, gy, 1,
                                       *ARGS)


def test_gradients_and_dt_match():
    rng = np.random.default_rng(3)
    h, w = 23, 31
    ref, interest = rng.uniform(0, 100, (2, h, w))
    mv_u, mv_v = 3.0 * rng.normal(size=(2, h, w))
    for got, want in zip(tb.gradient_method_grad(*_t(interest)),
                         jb.gradient_method_grad(*_j(interest))):
        _close(got, want)
    _close(tb.gradient_method_dt(*_t(ref, interest, mv_u, mv_v)),
           jb.gradient_method_dt(*_j(ref, interest, mv_u, mv_v)))
    _close(tb.gradient_method_dt_zero(*_t(ref, interest)),
           jb.gradient_method_dt_zero(*_j(ref, interest)))
    zero = np.zeros((h, w))
    _close(tb.gradient_method_dt_zero(*_t(ref, interest)),
           tb.gradient_method_dt(*_t(ref, interest, zero, zero)))


@pytest.mark.parametrize("sup_mode", ["reference", "analytic"])
def test_gates_terms_energy_sup_match(gated_fields, sup_mode):
    gx, gy, it, labels, u0, v0 = gated_fields
    for a, b in zip(tb._region_gates(*_t(labels), torch.float64),
                    jb._region_gates(jnp.asarray(labels), jnp.float64)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tb._neighbor_terms(*_t(u0, v0, labels), ARGS[3]),
                    jb._neighbor_terms(*_j(u0, v0, labels), ARGS[3])):
        _close(a, b)
    _close(tb._neighbor_energy(*_t(u0, v0, labels), ARGS[3]),
           jb._neighbor_energy(*_j(u0, v0, labels), ARGS[3]))
    for a, b in zip(tb._gated_sup(*_t(gx, gy), *ARGS, sup_mode),
                    jb._gated_sup(*_j(gx, gy), *ARGS, sup_mode)):
        _close(a, b, atol=0, rtol=1e-15)
    with pytest.raises(ValueError, match="sup_mode"):
        tb._gated_sup(*_t(gx, gy), *ARGS, "bogus")


@pytest.mark.parametrize("iters,emt,kw", [
    (200, 0.0, {}),                                   # 4 checks, remainder
    (64, 0.0, {}),                                    # ends before check 2
    (300, 1e6, {}),                                   # stops at the 1st check
    (400, 0.0, {"sup_mode": "analytic", "plateau_rtol": 0.05}),
])
def test_irls_gradient_method_matches(gated_fields, iters, emt, kw):
    gx, gy, it, labels, _, _ = gated_fields
    want = jb.irls_gradient_method(*_j(gx, gy, it, labels), *ARGS, iters,
                                   emt, **kw)
    blocks = []
    got = tb.irls_gradient_method(*_t(gx, gy, it, labels), *ARGS, iters, emt,
                                  blocks=blocks, **kw)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert got[3] == int(want[3])
    _close(got[4], want[4], atol=0, rtol=TRACE_RTOL)
    # Launches: one sweep, then blocks of 64 in launches of 16, then the
    # remainder, up to the stop.
    sched = [1] + [64] * ((got[3] - 1) // 64) + [(got[3] - 1) % 64]
    assert blocks == [sum(-(-k // tb.DEFAULT_FUSE) for k in sched)]


def test_irls_warm_start_matches(gated_fields):
    gx, gy, it, labels, u0, v0 = gated_fields
    want = jb.irls_gradient_method(*_j(gx, gy, it, labels), *ARGS, 70, 0.0,
                                   *_j(u0, v0))
    got = tb.irls_gradient_method(*_t(gx, gy, it, labels), *ARGS, 70, 0.0,
                                  *_t(u0, v0))
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_irls_batched_freezes_stopped_element(stop_fields):
    gx, gy, its, labels = stop_fields
    want = jb.irls_gradient_method_batched(*_j(gx, gy, its, labels), *ARGS,
                                           200, 5.0)
    blocks = []
    got = tb.irls_gradient_method_batched(*_t(gx, gy, its, labels), *ARGS,
                                          200, 5.0, blocks=blocks)
    _close(got[0], want[0])
    _close(got[1], want[1])
    _close(got[4], want[4], atol=0, rtol=TRACE_RTOL)
    assert torch.isnan(got[4][0, 1]) and not torch.isnan(got[4][1, -1])
    assert blocks == [1 + 3 * 4 + 1]  # 1, 3 x 64 in 4 launches, then 7
    # Each element equals its serial refine, the stopped one included.
    for b in range(2):
        u, v, _, n, tr = tb.irls_gradient_method(
            *_t(gx, gy, its[b], labels), *ARGS, 200, 5.0)
        torch.testing.assert_close(got[0][b], u, rtol=0, atol=0)
        torch.testing.assert_close(got[4][b], tr, rtol=0, atol=0,
                                   equal_nan=True)


@pytest.mark.parametrize("iters,emt,fuse", [(200, 0.0, 16), (96, 1e6, 8)])
def test_irls_fast_matches(gated_fields, iters, emt, fuse):
    gx, gy, it, labels, _, _ = gated_fields
    want = jb.irls_gradient_method_fast(*_j(gx, gy, it, labels), *ARGS,
                                        iters, emt, fuse=fuse, tile_h=16,
                                        tile_w=128, interpret=True)
    got = tb.irls_gradient_method_fast(*_t(gx, gy, it, labels), *ARGS,
                                       iters, emt, fuse=fuse)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert got[3] == int(want[3])
    _close(got[4], want[4], atol=0, rtol=TRACE_RTOL)


def test_bidirectional_refine_matches():
    """tests/test_bm_flow.py:243-268 on Lab-like frames: against
    tpuflow's batched refine, and equal to the port's serial refines."""
    rng = np.random.default_rng(3)
    h, w = 24, 40
    ref_prev, interest, ref_next = rng.normal(size=(3, h, w, 3))
    labels = rng.integers(0, 3, (h, w)).astype(np.int32)
    want = jb.gradient_method_flow_bidirectional(
        _j(ref_prev, ref_next), jnp.asarray(interest), jnp.asarray(labels),
        iter_max=96, error_min_threshold=1e-6)
    got = tb.gradient_method_flow_bidirectional(
        _t(ref_prev, ref_next), *_t(interest, labels), iter_max=96,
        error_min_threshold=1e-6)
    zeros = torch.zeros((h, w), dtype=torch.float64)
    for (u, v), (uj, vj), ref in zip(got, want, (ref_prev, ref_next)):
        _close(u, uj)
        _close(v, vj)
        us, vs = tb.gradient_method_flow(*_t(ref, interest), zeros, zeros,
                                         *_t(labels), iter_max=96,
                                         error_min_threshold=1e-6,
                                         zero_warp=True)
        torch.testing.assert_close(u, us, rtol=0, atol=0)
        torch.testing.assert_close(v, vs, rtol=0, atol=0)


def test_refine_with_warp_matches():
    rng = np.random.default_rng(8)
    h, w = 24, 32
    ref, interest = rng.uniform(0, 1, (2, h, w, 3))
    mv_u, mv_v = rng.normal(0, 2, (2, h, w))
    labels = rng.integers(0, 4, (h, w)).astype(np.int32)
    want = jb.gradient_method_flow(*_j(ref, interest, mv_u, mv_v, labels),
                                   iter_max=80)
    got = tb.gradient_method_flow(*_t(ref, interest, mv_u, mv_v, labels),
                                  iter_max=80)
    for a, b in zip(got, want):
        _close(a, b)


def test_energy_trace_telemetry(gated_fields):
    """The refine's E(n) goes through the port's telemetry."""
    import io

    from tpuflow_torch.utils.telemetry import (Telemetry, get_telemetry,
                                               set_telemetry)

    gx, gy, it, labels, _, _ = gated_fields
    sink = io.StringIO()
    prev = get_telemetry()
    set_telemetry(Telemetry(sink))
    try:
        ref = torch.zeros((40, 70, 3), dtype=torch.float64)
        interest = torch.from_numpy(
            np.random.default_rng(1).uniform(0, 1, (40, 70, 3)))
        tb.gradient_method_flow(ref, interest, None, None,
                                *_t(labels), iter_max=130, zero_warp=True)
    finally:
        set_telemetry(prev)
    lines = [ln for ln in sink.getvalue().splitlines() if "irls.energy" in ln]
    assert len(lines) == 3  # after sweeps 1, 65, 129
    trace = EnergyTrace()
    trace.record(0, 0, 1.0)
    assert trace.as_dict() == {"0": [(0, 1.0)]}


def test_compensate_and_metrics_match():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (20, 26, 3))
    u, v = rng.normal(0, 3, (2, 20, 26))
    u[0, 0] = 0.5  # a half: both round half to even
    for method in ("nearest", "bilinear"):
        _close(compensate(*_t(img, u, v), method),
               j_compensate(*_j(img, u, v), method))
        _close(compensate(*_t(img[..., 0], u, v), method),
               j_compensate(*_j(img[..., 0], u, v), method))
    with pytest.raises(ValueError, match="method"):
        compensate(*_t(img, u, v), "cubic")
    for mean in (True, False):
        _close(tmetrics.epe(*_t(u, v, v, u), mean=mean),
               jmetrics.epe(*_j(u, v, v, u), mean=mean))
        _close(tmetrics.angular_error(*_t(u, v, v, u), mean=mean),
               jmetrics.angular_error(*_j(u, v, v, u), mean=mean))


# -- the flagship over three frames -------------------------------------------

SEG_R = 8
FLAGSHIP_KW = dict(search_range=7, kernel_spatial=SEG_R, iter_max=130)


@pytest.fixture(scope="module")
def three_frames():
    """chip_smoke's pan over shaded Voronoi cells at 40x56: 150 cells in
    the scene (frame and border), pan (1, 2) px per frame. The third frame
    is noisier, so the middle frame's two match directions never tie."""
    frames, _ = voronoi_frames((40, 56), cells_per_px=150 / (56 * 72),
                               pan=(1, 2), shade=1.875, seed=1)
    for f in frames:  # the fixture is within the filter's drift contract
        lab = j_srgb_to_lab(jnp.asarray(f, jnp.float32) / 255.0)
        drift = j_ms_filter(lab, SEG_R, 16 / 255.0, 8, with_drift=True)[2]
        assert float(drift) <= SEG_R
    return frames


@pytest.fixture(scope="module")
def tpuflow_run(three_frames):
    f0, f1, f2 = three_frames
    out1, state = jb.optical_flow_block_matching(f0, f1, **FLAGSHIP_KW)
    warm = tb.BMFlowState.from_tpuflow(state, "cpu")
    out2, _ = jb.optical_flow_block_matching(f1, f2, state=state,
                                             **FLAGSHIP_KW)
    return out1, out2, warm


def _assert_outputs_match(got, want):
    seg, wseg = got.segmentation, want.segmentation
    assert seg.n_regions == wseg.n_regions
    np.testing.assert_array_equal(seg.labels, wseg.labels)
    np.testing.assert_array_equal(got.bm_u, want.bm_u)
    np.testing.assert_array_equal(got.bm_v, want.bm_v)
    np.testing.assert_array_equal(got.t, want.t)
    _close(got.u, want.u, atol=FLAGSHIP_ATOL)
    _close(got.v, want.v, atol=FLAGSHIP_ATOL)
    np.testing.assert_array_equal(got.quantized_rgb, want.quantized_rgb)
    _close(got.shift_vector, want.shift_vector, atol=1e-4)
    assert got.bidirectional == want.bidirectional


def test_flagship_three_frames_match(three_frames, tpuflow_run):
    f0, f1, f2 = three_frames
    blocks = []
    out1, state = tb.optical_flow_block_matching(f0, f1, device="cpu",
                                                 blocks=blocks, **FLAGSHIP_KW)
    out2, state = tb.optical_flow_block_matching(f1, f2, state=state,
                                                 device="cpu", blocks=blocks,
                                                 **FLAGSHIP_KW)
    _assert_outputs_match(out1, tpuflow_run[0])
    _assert_outputs_match(out2, tpuflow_run[1])
    assert not out1.bidirectional and out2.bidirectional
    assert set(np.unique(out2.t)) == {-1, 1}
    # Checks after sweeps 1, 65 and 129; launches 1 + 4 + 4 + 1 per refine.
    assert blocks == [10, 10]
    assert len(state.lab_frames) == 3 and state.segmentations[0].n_regions


def test_flagship_from_warm_tpuflow_state(three_frames, tpuflow_run):
    """Pair 2 from tpuflow's own state after pair 1."""
    _, f1, f2 = three_frames
    out2, _ = tb.optical_flow_block_matching(f1, f2, state=tpuflow_run[2],
                                             device="cpu", **FLAGSHIP_KW)
    _assert_outputs_match(out2, tpuflow_run[1])


def test_flagship_refine_warp_matches(three_frames):
    """refine_warp=True: the refine's dt under the real BM field, in both
    the unidirectional and the batched bidirectional refine."""
    f0, f1, f2 = three_frames
    kw = dict(FLAGSHIP_KW, refine_warp=True, iter_max=66)
    want1, wstate = jb.optical_flow_block_matching(f0, f1, **kw)
    want2, _ = jb.optical_flow_block_matching(f1, f2, state=wstate, **kw)
    got1, state = tb.optical_flow_block_matching(f0, f1, device="cpu", **kw)
    got2, _ = tb.optical_flow_block_matching(f1, f2, state=state,
                                             device="cpu", **kw)
    _assert_outputs_match(got1, want1)
    _assert_outputs_match(got2, want2)


def test_flagship_quality_profile_runs(three_frames):
    f0, f1, f2 = three_frames
    kw = dict(FLAGSHIP_KW, profile="quality", iter_max=64)
    out1, state = tb.optical_flow_block_matching(f0, f1, device="cpu", **kw)
    out2, state = tb.optical_flow_block_matching(f1, f2, state=state,
                                                 device="cpu", **kw)
    for out in (out1, out2):
        assert out.u.shape == f0.shape[:2]
        assert np.isfinite(out.u).all() and np.isfinite(out.v).all()
    # The stride-2 segmentation, nearest-replicated back to full size.
    np.testing.assert_array_equal(out2.segmentation.labels[::2, ::2],
                                  out2.segmentation.labels[1::2, 1::2])


def test_flagship_refuses_unported(three_frames):
    """What the driver still refuses: an unknown profile or search method,
    and a stride-``seg_scale`` segmentation on a mesh (as tpuflow). Every
    profile names a ported method (tests/test_torch_bm_methods.py runs
    fast and turbo)."""
    f0, f1, _ = three_frames
    for profile, knobs in tb.PROFILES.items():
        tb.matcher.validate_method(knobs.get("bm_method", "matmul"))
        assert knobs == jb.PROFILES[profile]
    with pytest.raises(ValueError, match="profile"):
        tb.optical_flow_block_matching(f0, f1, profile="bogus", device="cpu")
    with pytest.raises(ValueError, match="unknown block-matching"):
        tb.optical_flow_block_matching(f0, f1, bm_method="matmul_fp16",
                                       device="cpu")
    from tpuflow_torch.segmentation import meanshift

    with pytest.raises(ValueError, match="single-device"):
        meanshift.segment_meanshift_async(torch.zeros((8, 8, 3)), 4,
                                          scale=2, mesh=object())
    assert MultipleMotionParam().bm_search_range == 61


def test_mode_constants_match():
    import tpuflow.core.config as jconfig
    import tpuflow_torch.core.config as tconfig

    names = [n for n in dir(jconfig) if n.startswith("MODE_OUTPUT_")]
    assert len(names) == 9
    for n in names:
        assert getattr(tconfig, n) == getattr(jconfig, n), n
