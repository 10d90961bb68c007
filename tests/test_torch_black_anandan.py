"""tpuflow_torch Black-Anandan (both pyramids, the IRLS sweep, the pyramid
helpers, the M-estimators) against tpuflow, on the CPU in float64.

The port takes the plain version of its IRLS kernel (CPU tensors);
tpuflow's Pallas kernel runs in interpret mode. Tolerances follow the
JAX package's own tests: 1e-12 for pointwise functions, atol 1e-11 for
fused sweeps (tests/test_kernels.py), rtol 1e-7 / atol 1e-9 for the whole
pyramid (tests/test_black_anandan.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import tpuflow.pyramid as jpyr
import tpuflow.solvers.black_anandan as jba
import tpuflow.solvers.black_anandan_fast as jbaf
import tpuflow.solvers.mestimators as jme
from tpuflow.core.config import MultipleMotionParam as JParam
from tpuflow.kernels import irls_sweep_pallas
import tpuflow_torch.pyramid as tpyr
import tpuflow_torch.solvers.black_anandan as tba
import tpuflow_torch.solvers.black_anandan_fast as tbaf
import tpuflow_torch.solvers.mestimators as tme
from tpuflow_torch.core.config import MultipleMotionParam
from tpuflow_torch.kernels import irls_stencil
from tpuflow_torch.utils.telemetry import EnergyTrace

LD, LS, SD, SS = 5.0, 1.0, 0.4, 0.2


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(t, j, rtol=0.0, atol=1e-12):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_allclose(t, np.asarray(j), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def frames():
    """bench.py::_frames_kitti's textured pair, cropped to 64x80."""
    rng = np.random.default_rng(1)
    base = gaussian_filter(rng.uniform(0, 255, (72, 88)), 2.0)
    return base[:64, :80].copy(), base[4:68, 2:82].copy()


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(11)
    h, w = 45, 70  # deliberately not tile-aligned
    gx, gy = rng.normal(size=(h, w)), rng.normal(size=(h, w))
    gt = 0.3 * rng.normal(size=(h, w))
    u, v = 0.2 * rng.normal(size=(h, w)), 0.2 * rng.normal(size=(h, w))
    return u, v, gx, gy, gt


@pytest.mark.parametrize("name", ["geman_mcclure", "lorentzian"])
def test_mestimators_match(name):
    x = np.linspace(-3.0, 3.0, 101)
    for t_fn, j_fn in zip(tme.ESTIMATORS[name], jme.ESTIMATORS[name]):
        np.testing.assert_allclose(t_fn(torch.from_numpy(x), 0.7).numpy(),
                                   np.asarray(j_fn(jnp.asarray(x), 0.7)),
                                   rtol=1e-12)


def test_irls_grad_and_energy_match(fields):
    u, v, gx, gy, gt = fields
    gt_ = tba.irls_grad(*_t(u, v, gx, gy, gt), LD, LS, SD, SS)
    gj = jba.irls_grad(*map(jnp.asarray, (u, v, gx, gy, gt)), LD, LS, SD, SS)
    for a, b in zip(gt_, gj):
        _close(a, b)
    e_t = tba.irls_energy(*_t(u, v, gx, gy, gt), LD, LS, SD, SS)
    e_j = jba.irls_energy(*map(jnp.asarray, (u, v, gx, gy, gt)),
                          LD, LS, SD, SS)
    _close(e_t, e_j, rtol=1e-12)


@pytest.mark.parametrize("sup_mode", ["reference", "analytic"])
def test_irls_sup_matches(fields, sup_mode):
    _, _, gx, gy, _ = fields
    st = tba.irls_sup(*_t(gx, gy), LD, LS, SD, SS, sup_mode)
    sj = jba.irls_sup(jnp.asarray(gx), jnp.asarray(gy), LD, LS, SD, SS,
                      sup_mode)
    for a, b in zip(st, sj):
        _close(a, b, rtol=1e-14)
    with pytest.raises(ValueError):
        tba.irls_sup(*_t(gx, gy), LD, LS, SD, SS, "nope")


@pytest.mark.parametrize("n_iters,fuse", [(5, 2), (4, 4)])
def test_irls_sweeps_plain_matches_pallas_interpret(fields, n_iters, fuse):
    """The plain sweep on the ragged 45x70 frame against the TPU kernel in
    interpret mode (tiles of 16x128, so several tiles and a remainder)."""
    u, v, gx, gy, gt = fields
    sup = jba.irls_sup(jnp.asarray(gx), jnp.asarray(gy), LD, LS, SD, SS)
    uj, vj = irls_sweep_pallas(
        *map(jnp.asarray, (u, v, gx, gy, gt)), *sup, n_iters,
        lambda_d=LD, lambda_s=LS, sigma_d=SD, sigma_s=SS,
        tile_h=16, tile_w=128, fuse=fuse, interpret=True)
    tf = _t(u, v, gx, gy, gt)
    sup_t = _t(*sup)
    ut, vt = irls_stencil.irls_sweeps_plain(*tf, *sup_t, n_iters,
                                            LD, LS, SD, SS)
    _close(ut, uj, atol=1e-11)
    _close(vt, vj, atol=1e-11)
    # The dispatching wrapper takes the same plain version on the CPU.
    before = irls_stencil.LAUNCHES
    uw, vw = irls_stencil.irls_sweeps(*tf, *sup_t, n_iters, LD, LS, SD, SS)
    assert torch.equal(uw, ut) and torch.equal(vw, vt)
    assert irls_stencil.LAUNCHES == before


def test_irls_sweeps_reject_bad_sup(fields):
    tf = _t(*fields)
    with pytest.raises(ValueError):
        irls_stencil.irls_sweeps(*tf, torch.ones(2), torch.ones(1), 1)
    with pytest.raises(ValueError):
        irls_stencil.irls_sweeps(*tf, torch.ones(1), torch.ones(1), 0)


def test_pyramid_helpers_match(frames):
    prev, nxt = frames
    lt = tpyr.pyramider(torch.from_numpy(prev), 3)
    lj = jpyr.pyramider(jnp.asarray(prev), 3)
    lt1 = tpyr.pyramider(torch.from_numpy(nxt), 3)
    lj1 = jpyr.pyramider(jnp.asarray(nxt), 3)
    assert [tuple(a.shape) for a in lt] == [a.shape for a in lj]
    for a, b in zip(lt, lj):
        _close(a, b)
    for (gx, gy), (jx, jy) in zip(tpyr.grad_pyramid(lt),
                                  jpyr.grad_pyramid(lj)):
        _close(gx, jx)
        _close(gy, jy)
    for (gx, gy), (jx, jy) in zip(tpyr.grad_pyramid(lt, lt1),
                                  jpyr.grad_pyramid(lj, lj1)):
        _close(gx, jx)
        _close(gy, jy)
    for a, b in zip(tpyr.dt_pyramid(lt, lt1), jpyr.dt_pyramid(lj, lj1)):
        _close(a, b)
    rng = np.random.default_rng(2)
    uc, vc = 3.0 * rng.normal(size=(2,) + tuple(lt[2].shape))
    h, w = lt[1].shape
    _close(tpyr.upsample_nearest(torch.from_numpy(uc), (h, w)),
           jpyr.pyramid.upsample_nearest(jnp.asarray(uc), (h, w)), atol=0)
    _close(tpyr.level_down(lt[1], lt1[1], *_t(uc, vc)),
           jpyr.level_down(lj[1], lj1[1], jnp.asarray(uc), jnp.asarray(vc)))
    u, v = 0.1 * rng.normal(size=(2, h, w))
    for a, b in zip(tpyr.add_vector_offset(*_t(u, v, uc, vc)),
                    jpyr.add_vector_offset(*map(jnp.asarray, (u, v, uc, vc)))):
        _close(a, b)


def test_pyramid_tiny_image_levels():
    """Levels down to one pixel: the mirror pads outgrow the image."""
    img = np.random.default_rng(6).uniform(size=(3, 5))
    lt = tpyr.pyramider(torch.from_numpy(img), 4)
    lj = jpyr.pyramider(jnp.asarray(img), 4)
    for a, b in zip(lt, lj):
        _close(a, b)
    for (gx, gy), (jx, jy) in zip(tpyr.grad_pyramid(lt),
                                  jpyr.grad_pyramid(lj)):
        _close(gx, jx)
        _close(gy, jy)


def test_optical_flow_pyramid_matches(frames):
    prev, nxt = frames
    trace = EnergyTrace()
    u, v = tba.optical_flow_pyramid(
        *_t(prev, nxt), 255.0, MultipleMotionParam(level=2),
        iter_scale=0.05, energy_trace=trace)
    uj, vj = jba.optical_flow_pyramid(
        jnp.asarray(prev), jnp.asarray(nxt), 255.0, JParam(level=2),
        iter_scale=0.05)
    _close(u, uj, rtol=1e-7, atol=1e-9)
    _close(v, vj, rtol=1e-7, atol=1e-9)
    assert sorted(trace.levels) == [0, 1, 2]
    assert trace.levels[0][0][0] == 0  # iteration of the first E(n) print


def test_optical_flow_pyramid_fast_matches(frames):
    prev, nxt = frames
    param = MultipleMotionParam(level=2, error_min_threshold=0.0)
    blocks = []
    u, v = tbaf.optical_flow_pyramid_fast(
        *_t(prev, nxt), 255.0, param, iter_max=8, fuse=4, blocks=blocks)
    uj, vj = jbaf.optical_flow_pyramid_fast(
        jnp.asarray(prev), jnp.asarray(nxt), 255.0,
        JParam(level=2, error_min_threshold=0.0), iter_max=8, fuse=4,
        tile_h=32, tile_w=128, interpret=True)
    _close(u, uj, rtol=1e-7, atol=1e-9)
    _close(v, vj, rtol=1e-7, atol=1e-9)
    assert blocks == [2, 2, 2]


def _level_inputs(h=10, w=12, seed=7):
    r = np.random.default_rng(seed)
    return (np.zeros((h, w)), np.zeros((h, w)), r.normal(size=(h, w)),
            r.normal(size=(h, w)), 0.1 * r.normal(size=(h, w)))


@pytest.mark.parametrize("is_level0,threshold", [
    (True, 1e-6), (False, 1e-6), (True, 1e9), (False, 1e9)])
def test_level_energy_trace_matches(is_level0, threshold):
    """E(n) every 64 sweeps, NaN past the stop; a huge threshold stops
    after the first sweep."""
    args = _level_inputs()
    ut, vt, Et, nt, trt = tba.irls_optical_flow_level(
        *_t(*args), LD, LS, SD, SS, 170, threshold, is_level0)
    uj, vj, Ej, nj, trj = jba.irls_optical_flow_level(
        *map(jnp.asarray, args), LD, LS, SD, SS, 170, threshold, is_level0)
    assert nt == int(nj)
    _close(ut, uj, atol=1e-11)
    _close(trt, trj, rtol=1e-10)  # NaN positions must agree too
    assert np.isfinite(trt.numpy()[0])
    if threshold > 1:
        assert nt == 1 and np.isnan(trt.numpy()[1:]).all()


@pytest.mark.parametrize("is_level0", [True, False])
def test_level_fast_blocks_and_trace_match(is_level0):
    args = _level_inputs()
    ut, vt, Et, bt, trt = tbaf.irls_level_fast(
        *_t(*args), SD, SS, 200, 1e-6, is_level0, fuse=16)
    uj, vj, Ej, bj, trj = jbaf.irls_level_fast(
        *map(jnp.asarray, args), SD, SS, 200, 1e-6, is_level0, fuse=16,
        tile_h=16, tile_w=128, interpret=True)
    assert bt == int(bj)
    _close(ut, uj, atol=1e-11)
    _close(vt, vj, atol=1e-11)
    _close(trt, trj, rtol=1e-10)


def test_global_telemetry_emits_energy_events(frames):
    """With global telemetry on and no EnergyTrace, the fast pyramid still
    emits one irls.energy event per stop check: every fuse=4 sweeps at
    level 1, none at level 0, whose first check would come at sweep 64."""
    import io
    import json

    from tpuflow_torch.utils import telemetry

    stream = io.StringIO()
    old = telemetry.get_telemetry()
    telemetry.set_telemetry(telemetry.Telemetry(stream))
    try:
        tbaf.optical_flow_pyramid_fast(
            *_t(*frames), 255.0, MultipleMotionParam(level=1),
            iter_max=8, fuse=4)
    finally:
        telemetry.set_telemetry(old)
    events = [json.loads(line) for line in stream.getvalue().splitlines()]
    assert [(e["level"], e["iteration"]) for e in events] == \
        [(1, 4), (1, 8)]
    assert all(e["event"] == "irls.energy" for e in events)
