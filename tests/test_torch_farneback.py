"""tpuflow_torch's Farneback slice against tpuflow's, on the CPU in float64.

The same seeded numpy frames go through ``tpuflow.solvers.
calc_optical_flow_farneback`` and its port. The port warps with the
four-corner clamped gather only, which is tpuflow's formula with
``dense_warp_d=0``: against that the two agree to atol 1e-9 x max(1,
max|u|) (they sum the separable taps, the G^-1 combination and the
resize in different orders, so not bitwise). tpuflow's default warp
(dense shifts under a displacement bound, else per-tile pre-shifts) equals
the gather up to weight-rounding ulps; against it the bound is 1e-8.

Sizes are reduced from the bench's (1080x1920, 375x1242) to tens of
pixels; the configurations are the bench's four (bench.py:207-248) and
the flag and kernel switches. On CPU tensors the port takes its kernels'
plain versions, so no kernel is launched here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from tpuflow.solvers import farneback as jfb
from tpuflow.solvers import calc_optical_flow_farneback as j_farneback
from tpuflow_torch.core.resample import resize_linear
from tpuflow_torch.kernels import fb_kernels, sepconv
from tpuflow_torch.solvers import calc_optical_flow_farneback
from tpuflow_torch.solvers import farneback as tfb

ATOL = 1e-9
ATOL_DEFAULT_WARP = 1e-8


def _noise_pair(h, w, seed=0):
    """bench.py::_frames_1080p's recipe: uniform noise, 2-px roll, noise."""
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0, 255, (h, w))
    return prev, np.roll(prev, 2, axis=1) + rng.normal(0, 1, (h, w))


def _smooth_pair(h, w, seed=1):
    """bench.py::_frames_kitti's recipe: smoothed noise shifted by (4, 2)."""
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.uniform(0, 255, (h + 8, w + 8)), 2.0)
    return base[:h, :w].copy(), base[4 : 4 + h, 2 : 2 + w].copy()


def _block_pair(h, w, pan=4, seed=9):
    """bench.py::bench_farneback_demo3_largemotion's recipe at a small
    size: multi-octave texture, a global pan and a counter-moving block."""
    rng = np.random.default_rng(seed)

    def octave(sigma):
        g = gaussian_filter(rng.uniform(0, 1, (h, w + pan + 8)), sigma)
        return (g - g.mean()) / g.std()

    base = octave(1.5) + octave(4.0)
    base = (base - base.min()) * (255.0 / (base.max() - base.min()))
    prev = base[:, :w].copy()
    nxt = base[:, pan : pan + w].copy()
    bh, bw = h // 3, w // 3
    nxt[bh : 2 * bh, bw : 2 * bw] = prev[bh - 2 : 2 * bh - 2,
                                         bw + 3 : 2 * bw + 3]
    return prev, nxt


STREAM = (0.4, 1, 48, 2, 8, 1.2)   # DenseFlow.cpp:37
DEMO = (0.5, 1, 64, 2, 8, 1.6)     # FarnebackOF.cpp:24
DEMO3 = (0.5, 3, 15, 3, 5, 1.2)    # HornSchunckOF/main.cpp:111

BENCH_CASES = {
    "stream": (STREAM, lambda: _noise_pair(57, 83)),
    "demo_kitti": (DEMO, lambda: _smooth_pair(57, 83)),
    "demo3": (DEMO3, lambda: _noise_pair(48, 64)),
    "demo3_largemotion": (DEMO3, lambda: _block_pair(48, 64)),
}


def _port(prev, nxt, cfg, flow=None, **kw):
    t = [torch.from_numpy(a) for a in (prev, nxt)]
    if flow is not None:
        flow = tuple(torch.from_numpy(f) for f in flow)
    u, v = calc_optical_flow_farneback(*t, flow, *cfg, **kw)
    assert u.dtype == torch.float64 and u.shape == prev.shape
    return u.numpy(), v.numpy()


def _jax(prev, nxt, cfg, flow=None, **kw):
    u, v = j_farneback(jnp.asarray(prev), jnp.asarray(nxt), flow, *cfg, **kw)
    return np.asarray(u), np.asarray(v)


def _assert_flow_close(got, ref, atol):
    bound = atol * max(1.0, float(np.abs(ref[0]).max()),
                       float(np.abs(ref[1]).max()))
    for a, b in zip(got, ref):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=bound)


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_bench_configs_match_tpuflow_gather_warp(case):
    cfg, frames = BENCH_CASES[case]
    prev, nxt = frames()
    before = sepconv.LAUNCHES, dict(fb_kernels.LAUNCHES)
    got = _port(prev, nxt, cfg)
    assert (sepconv.LAUNCHES, fb_kernels.LAUNCHES) == before
    _assert_flow_close(got, _jax(prev, nxt, cfg, dense_warp_d=0), ATOL)
    # The flow is real motion, not a degenerate solve.
    assert 1.0 < np.abs(got[0]).max() < 50.0


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_bench_configs_match_tpuflow_default_warp(case):
    cfg, frames = BENCH_CASES[case]
    prev, nxt = frames()
    _assert_flow_close(_port(prev, nxt, cfg), _jax(prev, nxt, cfg),
                       ATOL_DEFAULT_WARP)


@pytest.mark.parametrize("cfg,kw", [
    ((0.5, 2, 15, 2, 5, 1.1), dict(flags=0x200)),
    ((0.5, 1, 12, 2, 5, 1.1), dict(flags=0x200)),
    (DEMO3, dict(use_poly_kernel=False)),
    (STREAM, dict(use_blur_kernel=True)),
    ((0.5, 2, 15, 2, 5, 1.2), dict(use_blur_kernel=True)),
])
def test_switches_match_tpuflow(cfg, kw):
    """Gaussian aggregation (odd and even windows), the separable-moment
    expansion and the fused blur-solve. tpuflow is called on its default
    CPU path, which computes the same math; its Pallas kernels run only in
    interpret mode here (tests/test_torch_fb_kernels.py)."""
    prev, nxt = _smooth_pair(44, 60)
    jkw = {"flags": kw["flags"]} if "flags" in kw else {}
    _assert_flow_close(_port(prev, nxt, cfg, **kw),
                       _jax(prev, nxt, cfg, dense_warp_d=0, **jkw), ATOL)


@pytest.mark.parametrize("levels", [1, 2])
def test_initial_flow_matches_tpuflow(levels):
    """flags=0x100 with a smooth initial flow, resized to the coarsest
    level and scaled (levels=2) or used as it is (levels=1)."""
    prev, nxt = _smooth_pair(44, 60)
    rng = np.random.default_rng(5)
    flow = (gaussian_filter(rng.normal(1.5, 1.0, prev.shape), 4.0),
            gaussian_filter(rng.normal(-0.5, 1.0, prev.shape), 4.0))
    cfg = (0.5, levels, 15, 2, 5, 1.2)
    got = _port(prev, nxt, cfg, flow=flow, flags=0x100)
    ref = _jax(prev, nxt, cfg, flow=flow, flags=0x100, dense_warp_d=0)
    _assert_flow_close(got, ref, ATOL)
    # Without the flag the flow argument is ignored, as in tpuflow.
    plain = _port(prev, nxt, cfg)
    assert np.array_equal(_port(prev, nxt, cfg, flow=flow), plain)


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("n,sigma", [(5, 1.1), (8, 1.2)])
def test_poly_expansion_matches_tpuflow(use_kernel, n, sigma):
    img = np.random.default_rng(n).uniform(0, 255, (37, 52))
    got = tfb.poly_expansion(torch.from_numpy(img), n, sigma, use_kernel)
    ref = jfb.poly_expansion(jnp.asarray(img), n, sigma)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-10 * float(np.abs(b).max()))


def test_update_matrices_matches_tpuflow_gather():
    """Flows up to +-6 px on a 30x41 frame: many queries leave the frame,
    so the ``inb`` switch and the corner clamps are exercised."""
    rng = np.random.default_rng(3)
    h, w = 30, 41
    R1 = [rng.normal(size=(h, w)) for _ in range(5)]
    R2 = [rng.normal(size=(h, w)) for _ in range(5)]
    u = rng.uniform(-6, 6, (h, w))
    v = rng.uniform(-6, 6, (h, w))
    t = [torch.from_numpy(a) for a in R1], [torch.from_numpy(a) for a in R2]
    got = tfb.update_matrices(*t, torch.from_numpy(u), torch.from_numpy(v))
    ref = jfb.update_matrices([jnp.asarray(a) for a in R1],
                              [jnp.asarray(a) for a in R2],
                              jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    zf = tfb.update_matrices(*t, torch.zeros(h, w, dtype=torch.float64),
                             torch.zeros(h, w, dtype=torch.float64),
                             zero_flow=True)
    zref = jfb.update_matrices([jnp.asarray(a) for a in R1],
                               [jnp.asarray(a) for a in R2],
                               jnp.zeros((h, w)), jnp.zeros((h, w)),
                               zero_flow=True)
    np.testing.assert_allclose(zf.numpy(), np.asarray(zref), rtol=0,
                               atol=1e-12)


def test_bilinear_matches_tpuflow_in_frame():
    """In-frame queries (the only ones update_matrices keeps) equal
    tpuflow's packed-table gather."""
    rng = np.random.default_rng(4)
    h, w = 23, 31
    fields = [rng.normal(size=(h, w)) for _ in range(5)]
    xq = rng.uniform(0, w - 1e-9, (h, w))
    yq = rng.uniform(0, h - 1e-9, (h, w))
    xq[0, :3] = [0.0, w - 1, w - 0.5]
    got = tfb._bilinear_all([torch.from_numpy(f) for f in fields],
                            torch.from_numpy(xq), torch.from_numpy(yq))
    ref = jfb._bilinear_all([jnp.asarray(f) for f in fields],
                            jnp.asarray(xq), jnp.asarray(yq))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-14)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((57, 83), (23, 33)),    # 0.4, rounded
    ((57, 83), (28, 42)),    # 0.5, rounded
    ((57, 83), (14, 21)),    # 0.25, rounded
    ((9, 83), (1, 33)),      # a 1-pixel side
    ((57, 83), (57, 42)),    # an axis whose size does not change
    ((23, 33), (57, 83)),    # upscale back
    ((1, 21), (3, 42)),      # upscale a 1-pixel side
])
def test_resize_linear_matches_jax_image_resize(in_hw, out_hw):
    img = np.random.default_rng(sum(in_hw)).normal(size=in_hw)
    got = resize_linear(torch.from_numpy(img), out_hw)
    ref = jax.image.resize(jnp.asarray(img), out_hw, method="linear")
    assert tuple(got.shape) == out_hw
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


def test_blur_solve_switch_agrees():
    """The fused blur-solve and the separable box + solve compute the same
    aggregation (sum then scale vs scaled taps), odd and even windows."""
    rng = np.random.default_rng(6)
    M = torch.from_numpy(rng.normal(size=(5, 26, 35)))
    M[0] = M[0].abs() + 2.0
    M[2] = M[2].abs() + 2.0
    for winsize in (7, 12):
        a = tfb._blur_solve(M, winsize, False, use_kernel=True)
        b = tfb._blur_solve(M, winsize, False)
        for x, y in zip(a, b):
            assert x.shape == (26, 35)
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                       atol=1e-12)
