"""tpuflow_torch region block matching against tpuflow, on the CPU.

Same float64 inputs, made with numpy from a seed, through both packages.
The winners (integer + subpixel displacements) must be equal exactly; the
costs are sums of the same terms in another order (XLA's dot and cumsum
vs PyTorch's), so they agree to rtol 1e-10, tpuflow's own bound between
its two evaluators (tests/test_bm_flow.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter
from scipy.ndimage import shift as ndshift

import tpuflow.blockmatching.matcher as jm
import tpuflow_torch.blockmatching.matcher as tm
from tpuflow_torch.utils.numerics import warm_cpu_sqrt

COST_RTOL, COST_ATOL = 1e-10, 1e-12
warm_cpu_sqrt()  # the ZNCC's sqrt is held to these tolerances


def _t(a):
    return torch.from_numpy(np.array(a))


def _random_pair(seed, h=37, w=53, shift=(2, -3), n_regions=9):
    """tests/test_bm_flow.py:270-291's fixture: odd height (a ragged last
    strip), random labels, a shifted noisy reference."""
    rng = np.random.default_rng(seed)
    cur = rng.uniform(0, 100, (h, w, 3))
    ref = np.roll(cur, shift, (0, 1)) + rng.normal(0, 0.5, (h, w, 3))
    labels = rng.integers(0, n_regions, (h, w)).astype(np.int32)
    return cur, ref, labels, n_regions


def _shift_pair():
    """tests/test_bm_flow.py:107-129: content moved by (-1, -2)."""
    from tpuflow.core.color import srgb_to_lab

    rng = np.random.default_rng(5)
    base = gaussian_filter(rng.uniform(0, 1, (48, 64, 3)), (2, 2, 0))
    prev_lab = np.array(srgb_to_lab(jnp.asarray(base[4:-4, 4:-4])))
    cur_lab = np.array(srgb_to_lab(jnp.asarray(base[6:-2, 5:-3])))
    labels = jm.grid_labels(40, 56, 8)
    return cur_lab, prev_lab, labels, int(labels.max()) + 1, 9, 1


def _subpixel_pair():
    """tests/test_bm_flow.py:347-368: a 1.5-px shift, cubic-interpolated."""
    rng = np.random.default_rng(9)
    base = gaussian_filter(rng.uniform(0, 1, (40, 48)), 2)
    cur = ndshift(base, (0.0, -1.5), order=3, mode="nearest")
    labels = jm.grid_labels(40, 48, 16)
    return (np.stack([cur] * 3, -1), np.stack([base] * 3, -1), labels,
            int(labels.max()) + 1, 7, 2)


def _assert_same(got: tm.BlockMatchResult, want: jm.BlockMatchResult):
    np.testing.assert_array_equal(got.region_uv, want.region_uv)
    np.testing.assert_allclose(got.region_cost, want.region_cost,
                               rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_array_equal(got.u, want.u)
    np.testing.assert_array_equal(got.v, want.v)


def test_grid_labels_and_candidates():
    np.testing.assert_array_equal(tm.grid_labels(10, 16, 8),
                                  jm.grid_labels(10, 16, 8))
    np.testing.assert_array_equal(tm.grid_labels(37, 53, 6),
                                  jm.grid_labels(37, 53, 6))
    np.testing.assert_array_equal(tm.search_candidates(15),
                                  jm.search_candidates(15))


def test_unknown_and_unported_methods():
    labels = tm.grid_labels(16, 16, 8)
    lab = torch.zeros((16, 16, 3))
    for bad in ("matmul_fp16", "gatherx", ""):
        with pytest.raises(ValueError, match="unknown block-matching"):
            tm.block_matching_labels(lab, lab, labels, 4, search_range=3,
                                     subpixel_scale=1, method=bad)
    # Every tpuflow method is ported: each runs (here on equal textured
    # frames, where every region's best displacement is zero).
    tex = _t(np.random.default_rng(0).uniform(0, 100, (16, 16, 3)))
    for later in ("matmul_bf16", "matmul_coarse", "matmul_half2"):
        assert later in jm.METHODS and later in tm.METHODS
        res = tm.block_matching_labels(tex, tex, labels, 4, search_range=3,
                                       subpixel_scale=1, method=later)
        np.testing.assert_array_equal(res.region_uv, np.zeros((4, 2)))


def test_too_many_regions_refused():
    lab = torch.zeros((8, 8, 3))
    labels = np.zeros((8, 8), np.int32)
    with pytest.raises(ValueError, match=f"{tm.MAX_REGIONS + 1} regions"):
        tm.block_matching_labels(lab, lab, labels, tm.MAX_REGIONS + 1,
                                 search_range=3)


def test_region_plan_and_range_sums():
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 40, (37, 53)).astype(np.int32)
    perm, bounds = tm.region_reduction_plan(labels, 41)  # one empty region
    perm_j, bounds_j = jm.region_reduction_plan(labels, 41)
    np.testing.assert_array_equal(perm, perm_j)
    np.testing.assert_array_equal(bounds, bounds_j)
    fields = rng.normal(size=(labels.size, 5))[perm]
    for chunk in (512, 64):
        got = tm._contiguous_range_sums(_t(fields), _t(bounds), chunk)
        want = jm._contiguous_range_sums(jnp.asarray(fields),
                                         jnp.asarray(bounds), chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-12)


def test_cost_core_matches():
    rng = np.random.default_rng(3)
    sums = rng.uniform(0, 5, (4, 6, 7))
    sums[..., 0] = rng.integers(0, 3, (4, 6))  # some empty regions
    for got, want in zip(tm._cost_from_sums(_t(sums)),
                         jm._cost_from_sums(jnp.asarray(sums), jnp.float64)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("method", ["matmul", "gather"])
@pytest.mark.parametrize("seed,subpixel", [(3, 2), (7, 1), (11, 3)])
def test_labels_match_random(method, seed, subpixel):
    cur, ref, labels, n = _random_pair(seed)
    got = tm.block_matching_labels(_t(cur), _t(ref), labels, n, 15,
                                   subpixel_scale=subpixel, method=method)
    want = jm.block_matching_labels(jnp.asarray(cur), jnp.asarray(ref),
                                    labels, n, 15, subpixel_scale=subpixel,
                                    method=method)
    _assert_same(got, want)


@pytest.mark.parametrize("method", ["matmul", "gather"])
@pytest.mark.parametrize("fixture", [_shift_pair, _subpixel_pair])
def test_labels_match_shifted_content(method, fixture):
    cur, ref, labels, n, search, subpixel = fixture()
    got = tm.block_matching_labels(_t(cur), _t(ref), labels, n, search,
                                   subpixel_scale=subpixel, method=method)
    want = jm.block_matching_labels(jnp.asarray(cur), jnp.asarray(ref),
                                    labels, n, search,
                                    subpixel_scale=subpixel, method=method)
    _assert_same(got, want)
    # The fixtures' motion, as tests/test_bm_flow.py asserts it.
    if fixture is _shift_pair:
        assert abs(np.median(got.u) - 1.0) < 0.51
        assert abs(np.median(got.v) - 2.0) < 0.51
    else:
        assert abs(np.median(got.u) - 1.5) < 0.26


@pytest.mark.parametrize("method", ["matmul", "gather"])
def test_bidirectional_device_match(method):
    """tests/test_bm_flow.py:293-320's fixture: both directions against
    tpuflow's fused program, and the fused evaluator against the port's
    own single-direction one (the same sums, so equal exactly)."""
    rng = np.random.default_rng(9)
    h, w = 37, 53
    cur = rng.uniform(0, 100, (h, w, 3))
    refp = np.roll(cur, (2, -3), (0, 1)) + rng.normal(0, 0.5, (h, w, 3))
    refn = np.roll(cur, (-1, 2), (0, 1)) + rng.normal(0, 0.5, (h, w, 3))
    labels = rng.integers(0, 9, (h, w)).astype(np.int32)
    plan = tm.region_plan(labels, 9, "cpu")
    got = tm._match_device_bidirectional(_t(cur), _t(refp), _t(refn), plan,
                                         15, 1.0, 0.5, 2, 16, method)
    want = jm._match_device_bidirectional(
        jnp.asarray(cur), jnp.asarray(refp), jnp.asarray(refn), labels, 9,
        15, 1.0, 0.5, 2, 16, method)
    for (uv_t, c_t), (uv_j, c_j), ref in zip(got, want, (refp, refn)):
        np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j)[:9])
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j)[:9],
                                   rtol=COST_RTOL, atol=COST_ATOL)
        uv_s, c_s = tm._match_device(_t(cur), _t(ref), plan, 15, 1.0, 0.5,
                                     2, 16, method)
        torch.testing.assert_close(uv_t, uv_s, rtol=0, atol=0)
        torch.testing.assert_close(c_t, c_s, rtol=0, atol=0)


def test_bidirectional_time_direction():
    """tests/test_bm_flow.py:370-394: symmetric constant motion."""
    rng = np.random.default_rng(3)
    base = gaussian_filter(rng.uniform(0, 1, (44, 60)), 2)

    def mk(g):
        return np.stack([g] * 3, -1)

    prev, cur, nxt = mk(base[2:-6]), mk(base[4:-4]), mk(base[6:-2])
    labels = tm.grid_labels(36, 60, 12)
    n = int(labels.max()) + 1
    r_prev, r_next, t = tm.block_matching_bidirectional(
        _t(cur), _t(prev), _t(nxt), labels, n, search_range=7,
        subpixel_scale=1)
    w_prev, w_next, w_t = jm.block_matching_bidirectional(
        jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(nxt), labels, n,
        search_range=7, subpixel_scale=1)
    _assert_same(r_prev, w_prev)
    _assert_same(r_next, w_next)
    np.testing.assert_array_equal(t, w_t)
    assert abs(np.median(r_prev.v) - 2.0) < 0.51
    assert abs(np.median(r_next.v) + 2.0) < 0.51
