"""tpuflow_torch mean-shift segmentation against tpuflow, on the CPU.

The port's filter is the function of tpuflow's Pallas kernel (the full
(2E+1)^2 offset square at every iteration), here through its plain
version (CPU tensors); tpuflow's kernel runs in interpret mode. Both sum
the same float64 values in the same order, so they agree bitwise (atol
1e-12 admits nothing coarser). Against tpuflow's default jnp filter
(banded disc, iteration 0 at R) they agree only for in-contract queries,
so those tests assert tpuflow's own drift certificate first. The
labeling is host numpy on identical inputs: labels equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import tpuflow.segmentation.meanshift as jms
from tpuflow.kernels.ms_filter import mean_shift_filter_pallas
import tpuflow_torch.segmentation.meanshift as tms
from tpuflow_torch.kernels import ms_filter


def _smooth_lab(shape, seed, sigma=2.0):
    """Smooth colour field: its modes drift little (in contract)."""
    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.uniform(0, 1, shape), (sigma, sigma, 0))


def _two_region_lab(h=40, w=60, seed=0):
    """tests/test_bm_flow.py's two-region frame, as normalized Lab."""
    from tpuflow.core.color import srgb_to_lab

    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3))
    img[:, : w // 2] = 60
    img[:, w // 2 :] = 190
    img = np.clip(img + rng.uniform(-8, 8, (h, w, 3)), 0, 255)
    return np.array(srgb_to_lab(jnp.asarray(img / 255.0)))


def test_color_sentinel_matches():
    lab = np.random.default_rng(0).normal(size=(9, 13, 3))
    got = tms._color_sentinel(torch.from_numpy(lab), 0.3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jms._color_sentinel(jnp.asarray(lab), 0.3)))


@pytest.mark.parametrize("R,ki,iters,margin", [(4, 0.12, 3, None),
                                               (3, 0.2, 2, 1)])
def test_filter_matches_pallas_interpret(R, ki, iters, margin):
    """Multi-tile Pallas grid (16x128 tiles over 36x52), random colours:
    many queries out of contract, where only the square sweep agrees."""
    lab = np.random.default_rng(4).uniform(0, 1, (36, 52, 3))
    pos_t, col_t = tms.mean_shift_filter(torch.from_numpy(lab), R, ki,
                                         iters, margin)
    pos_j, col_j = mean_shift_filter_pallas(
        jnp.asarray(lab), R, ki, iters, margin, tile_h=16, tile_w=128,
        interpret=True)
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(col_t.numpy(), np.asarray(col_j), rtol=0,
                               atol=1e-12)


def test_filter_matches_pallas_interpret_wide_window():
    """A window past the card's staged form (E = R + margin = 53, which the
    card runs in its wide form), on a 12x20 frame: the square reaches far
    past the frame on every side."""
    lab = np.random.default_rng(53).uniform(0, 1, (12, 20, 3))
    pos_t, col_t = tms.mean_shift_filter(torch.from_numpy(lab), 4, 0.25, 2,
                                         49)
    pos_j, col_j = mean_shift_filter_pallas(
        jnp.asarray(lab), 4, 0.25, 2, 49, tile_h=16, tile_w=128,
        interpret=True)
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(col_t.numpy(), np.asarray(col_j), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("R,ki,iters,seed", [(6, 0.1, 4, 12), (4, 0.12, 3, 1),
                                             (3, 0.15, 5, 5)])
def test_filter_matches_jnp_in_contract(R, ki, iters, seed):
    lab = _smooth_lab((30, 44, 3), seed)
    pos_j, col_j, drift = jms.mean_shift_filter(jnp.asarray(lab), R, ki,
                                                iters, with_drift=True)
    assert float(drift) <= R, "fixture must stay within the drift margin"
    pos_t, col_t = tms.mean_shift_filter(torch.from_numpy(lab), R, ki, iters)
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(col_t.numpy(), np.asarray(col_j), rtol=0,
                               atol=1e-12)


def test_plain_is_the_wrapper_on_cpu():
    lab = torch.from_numpy(_smooth_lab((20, 24, 3), 1))
    before = ms_filter.LAUNCHES
    a = ms_filter.mean_shift_filter(lab, 3, 0.1, 2)
    b = ms_filter.mean_shift_filter_plain(lab, 3, 0.1, 2)
    assert ms_filter.LAUNCHES == before  # the CPU never counts a launch
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_wrapper_rejects():
    with pytest.raises(ValueError, match="H, W, 3"):
        ms_filter.mean_shift_filter(torch.zeros(4, 4), 2)
    with pytest.raises(ValueError, match="no kernel"):
        ms_filter.mean_shift_filter(torch.zeros(4, 4, 3, device="meta"), 2)


@pytest.mark.parametrize("seed,min_size", [(0, 16), (5, 1), (7, 40)])
def test_merge_labels_matches(seed, min_size):
    """The host labeling against tpuflow's numpy/scipy path on noisy
    modes (many tiny regions, so the absorption loop runs)."""
    rng = np.random.default_rng(seed)
    h, w = 24, 31
    ys, xs = np.mgrid[0:h, 0:w]
    pos = np.stack([xs, ys], -1) + rng.normal(0, 1.5, (h, w, 2))
    col = np.repeat(rng.uniform(0, 1, (h, w // 4 + 1, 3)), 4, 1)[:, :w]
    col = col + rng.normal(0, 0.01, (h, w, 3))
    got = tms._merge_labels(pos, col, 6.0, 0.08, min_size)
    want = jms._merge_labels_py(pos, col, 6.0, 0.08, min_size)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("scale", [1, 2])
def test_segment_matches(scale):
    lab = _smooth_lab((32, 40, 3), 12)
    want = jms.segment_meanshift(lab, 6, 0.1, iters=4, min_size=4,
                                 scale=scale)
    got = tms.segment_meanshift(torch.from_numpy(lab), 6, 0.1, iters=4,
                                min_size=4, scale=scale)
    assert got.n_regions == want.n_regions
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.shift_spatial, want.shift_spatial,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.shift_color, want.shift_color,
                               rtol=0, atol=1e-12)


def test_segment_two_regions_and_regions():
    """tests/test_bm_flow.py's two-region segmentation, through the port."""
    lab = _two_region_lab()
    want = jms.segment_meanshift(lab, 5, 16 / 255.0, iters=6, min_size=20)
    seg = tms.segment_meanshift(torch.from_numpy(lab), 5, 16 / 255.0,
                                iters=6, min_size=20)
    assert seg.n_regions == want.n_regions >= 2
    np.testing.assert_array_equal(seg.labels, want.labels)
    assert seg.labels[20, 5] != seg.labels[20, 55]
    regions = seg.build_regions()
    assert sum(len(r) for r in regions) == seg.labels.size
    for r, ref in zip(regions, want.build_regions()):
        np.testing.assert_array_equal(r, ref)


def test_segment_async_matches_sync():
    lab = torch.from_numpy(_smooth_lab((24, 30, 3), 2))
    a = tms.segment_meanshift_async(lab, 4, 0.1, iters=3, min_size=4)()
    b = tms.segment_meanshift(lab, 4, 0.1, iters=3, min_size=4)
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.shift_spatial, b.shift_spatial)
