"""tpuflow_torch.viz against tpuflow.viz, on the CPU: every function's
output equals tpuflow's pixel for pixel (and the 3-D projections and
particle steps value for value). Inputs are seeded numpy arrays at tens
of pixels; no tolerance anywhere.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.core.config import PlotParam as JPlotParam
from tpuflow.viz import colorwheel as jcw
from tpuflow.viz import plot2d as jp2
from tpuflow.viz import plot3d as jp3
from tpuflow.viz import quiver as jq
from tpuflow_torch.core import config as tcfg
from tpuflow_torch.viz import colorwheel as tcw
from tpuflow_torch.viz import plot2d as tp2
from tpuflow_torch.viz import plot3d as tp3
from tpuflow_torch.viz import quiver as tq

RNG = np.random.default_rng(21)


def _flow(h=23, w=37, s=3.0, dtype=np.float64):
    return (RNG.normal(0, s, (h, w)).astype(dtype),
            RNG.normal(0, s, (h, w)).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("max_flow", [None, 4.0])
def test_flow_to_color_matches(dtype, max_flow):
    u, v = _flow(dtype=dtype)
    u[0, 0] = v[0, 0] = 0.0
    got = tcw.flow_to_color(torch.from_numpy(u), torch.from_numpy(v),
                            max_flow)
    want = np.asarray(jcw.flow_to_color(jnp.asarray(u), jnp.asarray(v),
                                        max_flow))
    assert got.dtype == torch.uint8 and got.shape == (23, 37, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    from_numpy = tcw.flow_to_color(u, v, max_flow, device="cpu")
    np.testing.assert_array_equal(from_numpy.numpy(), want)


@pytest.mark.parametrize("kw", [
    dict(), dict(delta=4, scale=6.0, outlier=3.0),
    dict(delta=3, scale=-2.5, line_color=(1, 2, 3), tip_color=(4, 5, 6))])
def test_plot_quiver_matches(kw):
    img = RNG.integers(0, 256, (41, 53, 3)).astype(np.uint8)
    u, v = _flow(41, 53)
    got = tq.plot_quiver(img, u, v, **kw)
    np.testing.assert_array_equal(got, jq.plot_quiver(img, u, v, **kw))
    np.testing.assert_array_equal(tq.plot_quiver_plain(img, u, v, **kw),
                                  got)


@pytest.mark.parametrize("kw", [
    dict(), dict(delta=5, scale=2.0, dot_radius=1),
    dict(delta=7, scale=40.0, dot_radius=3, line_color=(9, 9, 9))])
def test_plot_quiver_cv_matches(kw):
    img = RNG.integers(0, 256, (41, 53)).astype(np.uint8)
    u, v = _flow(41, 53)
    np.testing.assert_array_equal(tq.plot_quiver_cv(img, u, v, **kw),
                                  jq.plot_quiver_cv(img, u, v, **kw))
    with pytest.raises(ValueError, match="shapes must agree"):
        tq.plot_quiver_cv(img[:-1], u, v)


def test_draw_tracks_cv_matches():
    img = RNG.integers(0, 256, (40, 60, 3)).astype(np.uint8)
    a = RNG.uniform(-5, 65, (30, 2))
    b = a + RNG.normal(0, 8, (30, 2))
    for r in (0, 1, 3):
        np.testing.assert_array_equal(
            tq.draw_tracks_cv(img, a, b, dot_radius=r),
            jq.draw_tracks_cv(img, a, b, dot_radius=r))


def _segments(n=12, w=50, h=30):
    return [SimpleNamespace(n=RNG.uniform(0, w), m=RNG.uniform(0, h),
                            x=RNG.uniform(0, w), y=RNG.uniform(0, h))
            for _ in range(n)]


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("size_out", [None, (75, 45)])
def test_plot_segments_matches(negate, size_out):
    segs = _segments()
    segs.append(SimpleNamespace(n=3.0, m=4.0, x=3.2, y=4.1))  # L == 0
    np.testing.assert_array_equal(
        tp2.plot_segments(segs, (50, 30), size_out, negate),
        jp2.plot_segments(segs, (50, 30), size_out, negate))


@pytest.mark.parametrize("color", [tcfg.RED, tcfg.GREEN, tcfg.BLUE])
@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("gray,maxint", [(True, 255), (False, 1023)])
def test_superimpose_matches(color, negate, gray, maxint):
    img = RNG.integers(0, maxint + 1, (30, 50) if gray else (30, 50, 3))
    plot = tp2.plot_segments(_segments(), (50, 30))
    np.testing.assert_array_equal(
        tp2.superimpose(img, plot, color, negate, maxint),
        jp2.superimpose(img, plot, color, negate, maxint))


def _params():
    values = dict(int_interval=2, latitude=450, longitude=300, center_x=20.0,
                  center_y=12.0, center_z=3.0, scale=4.0, plot_z_scale=0.2,
                  rotate_switch=1, mode_switch=1, fill_switch=1)
    return tcfg.PlotParam(**values), JPlotParam(**values)


def test_plot_param_and_constants_match():
    import tpuflow.core.config as jcfg

    assert dataclasses.asdict(tcfg.PlotParam()) == \
        dataclasses.asdict(JPlotParam())
    port = tcfg.from_tpuflow(_params()[1])
    assert isinstance(port, tcfg.PlotParam) and port == _params()[0]
    for name in ("PLOT_NEGATE", "PLOT_AS_RESAMPLED", "PLOT_RESAMPLED_IMG_ONLY",
                 "PLOT_INTENSITY_MAX", "NOT_SUPERIMPOSE", "RED", "GREEN",
                 "BLUE"):
        assert getattr(tcfg, name) == getattr(jcfg, name)


def test_projections_match():
    img = RNG.uniform(0, 255, (24, 40))
    tparam, jparam = _params()
    for got, want in zip(tp3.project_points(img, tparam, 255.0, (200, 160)),
                         jp3.project_points(img, jparam, 255.0, (200, 160))):
        np.testing.assert_array_equal(got, want)
    segs = _segments(6, 40, 24)
    assert tp3.project_segments(segs, tparam, (200, 160), 1.5) == \
        jp3.project_segments(segs, jparam, (200, 160), 1.5)


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("default_param", [False, True])
def test_render_scene_matches(grid, default_param):
    img = RNG.uniform(0, 255, (24, 40))
    tparam, jparam = (None, None) if default_param else _params()
    segs = _segments(5, 40, 24)
    np.testing.assert_array_equal(
        tp3.render_scene(img, tparam, segs, 255.0, (160, 120), grid),
        jp3.render_scene(img, jparam, segs, 255.0, (160, 120), grid))


def test_particle_steps_match():
    img = RNG.uniform(0, 255, (9, 13))
    t = tp3.ParticleState.from_image(img)
    j = jp3.ParticleState.from_image(img)
    for _ in range(3):
        t = tp3.gravity_step(tp3.galaxy_step(t, (4.0, 3.0, 1.0)))
        j = jp3.gravity_step(jp3.galaxy_step(j, (4.0, 3.0, 1.0)))
    assert t.shape == j.shape == (9, 13)
    for f in ("coord", "vel", "intensity"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the card default on a host without one")
def test_flow_to_color_numpy_defaults_to_the_card():
    """Numpy flows go to the card unless the caller passes device="cpu":
    on a host without CUDA the default call raises."""
    u, v = _flow()
    with pytest.raises((RuntimeError, AssertionError)):
        tcw.flow_to_color(u, v)
