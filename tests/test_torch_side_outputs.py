"""The flagship's side outputs (``tpuflow_torch.solvers.bm_flow``).

The colour-quantized image and the mean-shift shift field are held bit
for bit to the forms they are defined by, written out below: per-region
sums by ``np.add.at``, the mean table gathered per pixel in float64 and
then cast, and the shift field as an ``np.mgrid`` of pixel coordinates
subtracted and stacked. The uint8 cast truncates, so a mean x 255 that
lands on an integer (a uniform region of k/255) flips on a last-bit
change of the sums: the uniform case holds that.
"""

import numpy as np
import pytest

from tpuflow_torch.segmentation.meanshift import SegmentationResult
from tpuflow_torch.solvers import bm_flow


def _add_at_sums(rgb_norm, seg):
    sums = np.zeros((seg.n_regions, 3))
    np.add.at(sums, seg.labels.reshape(-1), rgb_norm.reshape(-1, 3))
    return sums


def _add_at_quantize(rgb_norm, seg):
    flat = seg.labels.reshape(-1)
    counts = np.maximum(np.bincount(flat, minlength=seg.n_regions), 1)
    means = np.clip(_add_at_sums(rgb_norm, seg) / counts[:, None] * 255.0,
                    0, 255)
    return means[seg.labels].astype(np.uint8)


def _mgrid_shift(shift_spatial):
    h, w = shift_spatial.shape[:2]
    xy = np.mgrid[0:h, 0:w]
    return np.stack([shift_spatial[..., 0] - xy[1],
                     shift_spatial[..., 1] - xy[0]], axis=-1)


def _blocks(h, w, by, bx):
    """Rectangular regions of by x bx pixels, numbered row by row."""
    return ((np.arange(h)[:, None] // by) * -(-w // bx)
            + np.arange(w)[None, :] // bx).astype(np.int32)


def _random_unused(rng, h, w):
    # ids drawn from twice the regions there are: about half never occur
    n = 64
    return rng.integers(0, n, (h, w)).astype(np.int32) * 2, 2 * n


def _single(rng, h, w):
    return np.zeros((h, w), np.int32), 1


def _uniform(rng, h, w):
    labels = _blocks(h, w, 4, 8)
    return labels, int(labels.max()) + 1


def _many_small(rng, h, w):
    labels = _blocks(h, w, 2, 2)
    return labels, int(labels.max()) + 1


CASES = {
    "random_unused_ids": (_random_unused, (48, 64)),
    "single_region": (_single, (40, 52)),
    "uniform_k_over_255": (_uniform, (64, 128)),
    "many_small": (_many_small, (60, 84)),
    "odd_non_square": (_random_unused, (37, 91)),
    "flagship_size": (lambda rng, h, w: (_blocks(h, w, 16, 16),
                                         _blocks(h, w, 16, 16).max() + 1),
                      (375, 1242)),
}


def _case(name, seed=20):
    make, (h, w) = CASES[name]
    rng = np.random.default_rng(seed)
    labels, n = make(rng, h, w)
    # exponents spread over 2^-30..1, so that float64 sums round and the
    # order of the adds shows in their bits
    rgb = (rng.random((h, w, 3), dtype=np.float32)
           * np.exp2(rng.integers(-30, 1, (h, w, 3))).astype(np.float32))
    if name == "uniform_k_over_255":
        # each region one value k/255 in float32, k running over 0..255
        k = (labels % 256).astype(np.float32)
        rgb = np.repeat((k / np.float32(255.0))[..., None], 3, axis=-1)
    # converged positions: near each pixel's own, in float32 as the
    # filter gives them
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    pos = np.stack([xs, ys], axis=-1) + rng.normal(
        0, 3, (h, w, 2)).astype(np.float32)
    return SegmentationResult(labels=labels, n_regions=int(n),
                              shift_spatial=pos, shift_color=None), rgb


@pytest.mark.parametrize("name", list(CASES))
def test_side_outputs_bitwise(name):
    seg, rgb = _case(name)
    sums = bm_flow._region_sums(rgb, seg)
    want_sums = _add_at_sums(rgb, seg)
    assert sums.dtype == np.float64 and sums.shape == want_sums.shape
    np.testing.assert_array_equal(sums.view(np.uint64),
                                  want_sums.view(np.uint64))

    got = bm_flow._quantize_colors(rgb, seg)
    want = _add_at_quantize(rgb, seg)
    assert got.dtype == np.uint8 and got.shape == rgb.shape
    np.testing.assert_array_equal(got, want)

    shift = bm_flow._shift_vector(seg.shift_spatial)
    want_shift = _mgrid_shift(seg.shift_spatial)
    assert shift.dtype == np.float64 and shift.shape == (*seg.labels.shape, 2)
    np.testing.assert_array_equal(shift.view(np.uint64),
                                  want_shift.view(np.uint64))

    if name == "uniform_k_over_255":
        # k = 255: the mean x 255 lands on 255 exactly, so a sum one bit
        # low would truncate to 254
        counts = np.bincount(seg.labels.reshape(-1), minlength=seg.n_regions)
        scaled = want_sums[:, 0] / counts * 255.0
        assert np.any(scaled == 255.0) and np.any(got == 255)
