"""tpuflow_torch's Lucas-Kanade slice against tpuflow's, on the CPU in float64.

The same seeded numpy frames go through ``tpuflow.solvers.lucas_kanade``
and its port. Tolerances, each relative to max(1, max|reference|):

- ``box_filter`` (odd sizes through ``sep_conv2d`` with 1/size taps a
  side, where tpuflow takes the 2-D box of 1/size^2 taps; even sizes
  through ``conv2d``) and ``min_eigenvalue_response``: 1e-12 (measured
  3.2e-15 for the response: the two sum in different orders);
- ``good_features_to_track``: the same corners in the same order
  (exact);
- ``track_points``: status equal, points within 1e-9 px (measured
  2.8e-14);
- ``accept_tracked_point``: equal;
- ``dense_lucas_kanade``: 1e-9 (measured 1.9e-14 with |u| <= 4.5).

The port's CUDA kernel (sepconv) runs only on the card, where
chip_smoke.py holds it bitwise to its plain version; here the wrapper
takes the plain version, and a counting wrapper where ``ops.filters``
looks the kernel up checks the launches the card makes: 5 for the
Shi-Tomasi response, 33 for dense LK at its defaults.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.ops import filters as jfil
from tpuflow.solvers import lucas_kanade as jl
from tpuflow_torch.core import borders as tbd
from tpuflow_torch.kernels import sepconv
from tpuflow_torch.ops import filters as tfil
from tpuflow_torch.solvers import lucas_kanade as tl

RTOL = 1e-12
PT_ATOL = 1e-9
DENSE_ATOL = 1e-9


def _close(got, want, tol):
    want = np.asarray(want)
    bound = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=bound)


def _blurred_pair(seed, shape=(160, 200), shift=(3, 2)):
    """tests/test_lucas_kanade.py's ``textured_pair`` recipe: Gaussian-
    blurred uniform noise, the next frame cut ``shift`` = (rows, cols)
    further on (seed 7: point motion (+2, -3) in (x, y))."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.uniform(0, 255, shape), (0, 0), 2.0)
    dy, dx = shift
    prev = base[6:-6, 6:-6]
    nxt = base[6 + dy : base.shape[0] - 6 + dy, 6 - dx : base.shape[1] - 6 - dx]
    return prev.astype(np.float64), nxt.astype(np.float64)


@pytest.fixture(scope="module", params=[7, 11])
def pair(request):
    return _blurred_pair(request.param)


@pytest.mark.parametrize("size", [2, 4, 7, 15])
@pytest.mark.parametrize("border", [tbd.ZERO, tbd.REFLECT101])
def test_box_filter_matches(size, border):
    img = np.random.default_rng(size).normal(size=(23, 31))
    _close(tfil.box_filter(torch.from_numpy(img), size, border),
           jfil.box_filter(jnp.asarray(img), size, border), RTOL)


@pytest.mark.parametrize("block_size", [3, 5])
def test_min_eigenvalue_response_matches(pair, block_size):
    prev, _ = pair
    _close(tl.min_eigenvalue_response(torch.from_numpy(prev), block_size),
           jl.min_eigenvalue_response(jnp.asarray(prev), block_size), RTOL)


@pytest.mark.parametrize("args", [(100, 0.01, 10.0), (500, 0.05, 4.0)])
def test_good_features_same_corners_in_order(pair, args):
    prev, _ = pair
    got = tl.good_features_to_track(torch.from_numpy(prev), *args)
    want = jl.good_features_to_track(jnp.asarray(prev), *args)
    assert got.dtype == np.float64 and len(got) > 10
    np.testing.assert_array_equal(got, want)


def _grid_points():
    return np.stack(np.meshgrid(np.arange(20, 170, 13.5),
                                np.arange(20, 130, 11.25)),
                    -1).reshape(-1, 2).astype(np.float64)


@pytest.mark.parametrize("kw", [{}, dict(win=9, max_level=1, iters=4)])
def test_track_points_matches(pair, kw):
    """Corners and off-grid points (fractional positions, some near the
    border so the windows clamp)."""
    prev, nxt = pair
    pts = np.concatenate([
        jl.good_features_to_track(jnp.asarray(prev), 60, 0.01, 10),
        _grid_points(), [[1.5, 2.25], [185.0, 146.5]]])
    got, st = tl.track_points(torch.from_numpy(prev), torch.from_numpy(nxt),
                              pts, **kw)
    want, wst = jl.track_points(prev, nxt, pts, **kw)
    np.testing.assert_array_equal(st.numpy(), np.asarray(wst))
    _close(got.numpy(), want, PT_ATOL)
    assert st.any() and got.dtype == torch.float64


def test_track_points_flat_window_status():
    """A flat image has det(G) = 0: status False, the point unmoved."""
    flat = np.full((40, 50), 7.0)
    pts = np.array([[20.0, 20.0]])
    got, st = tl.track_points(torch.from_numpy(flat), torch.from_numpy(flat),
                              pts)
    want, wst = jl.track_points(flat, flat, pts)
    assert not bool(st[0]) and not bool(np.asarray(wst)[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_accept_tracked_point_matches():
    rng = np.random.default_rng(4)
    old = rng.uniform(0, 50, (64, 2))
    new = old + rng.normal(0, 2.0, (64, 2))
    st = rng.uniform(size=64) > 0.2
    got = tl.accept_tracked_point(old, new, st)
    want = jl.accept_tracked_point(old, new, st)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The rule itself (LucasKanadeOF.cpp:104-114).
    acc = tl.accept_tracked_point([[0.0, 0.0], [10.0, 10.0], [5.0, 5.0]],
                                  [[3.0, 0.0], [10.5, 10.5], [5.0, 5.0]],
                                  [True, True, True])
    assert acc.tolist() == [True, False, False]


@pytest.mark.parametrize("kw", [{}, dict(win=7, levels=2, iters=2),
                                dict(win=4, levels=1, iters=1)])
def test_dense_lucas_kanade_matches(pair, kw):
    prev, nxt = pair
    u, v = tl.dense_lucas_kanade(torch.from_numpy(prev),
                                 torch.from_numpy(nxt), **kw)
    uj, vj = jl.dense_lucas_kanade(jnp.asarray(prev), jnp.asarray(nxt), **kw)
    _close(u.numpy(), uj, DENSE_ATOL)
    _close(v.numpy(), vj, DENSE_ATOL)


def test_dense_lucas_kanade_recovers_shift():
    prev, nxt = _blurred_pair(7)
    u, v = tl.dense_lucas_kanade(torch.from_numpy(prev),
                                 torch.from_numpy(nxt))
    assert abs(float(u[30:-30, 30:-30].median()) - 2.0) < 0.2
    assert abs(float(v[30:-30, 30:-30].median()) + 3.0) < 0.2


@pytest.fixture
def sep_calls(monkeypatch):
    """Tap counts of each sepconv call, counted where ``ops.filters``
    looks the kernel up (the wrapper's CPU path still runs)."""
    calls = []

    def counting(padded, ky, kx):
        calls.append((len(ky), len(kx)))
        return sepconv.sep_conv2d_valid(padded, ky, kx)

    monkeypatch.setattr(tfil, "sep_conv2d_valid", counting)
    return calls


def test_sepconv_launches_of_the_lk_paths(sep_calls):
    """The launches the card makes: the Shi-Tomasi response 5 (two
    3-tap gradients, three 3-tap box sums), dense LK 33 at win 15, 3
    levels, 3 iterations (per level 2 gradients, 3 box sums, 2 a
    iteration), the box sums on the compiled 15-tap instantiation."""
    prev, nxt = (torch.from_numpy(a) for a in _blurred_pair(7))
    tl.good_features_to_track(prev)
    assert sep_calls == [(3, 3)] * 5
    sep_calls.clear()
    tl.dense_lucas_kanade(prev, nxt)
    assert len(sep_calls) == 33
    assert sep_calls.count((15, 15)) == 27 and sep_calls.count((3, 3)) == 6
    assert sepconv.instantiation(15, 15) == (15, 15)
    assert sepconv.instantiation(3, 3) == (0, 0)
    sep_calls.clear()
    tl.track_points(prev, nxt, _grid_points())
    assert sep_calls == []
