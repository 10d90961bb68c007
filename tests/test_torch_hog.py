"""HOG descriptors and HOG matching: tpuflow_torch against tpuflow on the
CPU in float64.

- ``orientation`` (signed and unsigned, 16 and 8 bins) and
  ``compute_hog`` (cells and dense), bitwise: the magnitude's
  ``gx*gx + gy*gy`` rounded once as XLA's CPU compiler fuses it, the
  dense sums in XLA's scan grouping;
- ``block_normalize`` within 4 ulps (relative 1e-15): tpuflow's XLA
  rewrites ``1 / sqrt`` into its CPU ``rsqrt``, which is not correctly
  rounded, the port divides by a correctly rounded root;
  ``block_normalize_integral`` (a true division in both) bitwise;
- ``hog_matching`` on tpuflow's descriptors: u, v and score bitwise,
  every chunk size, at the default 65x65 window and at smaller ones,
  with ties (flat regions) resolved first-better-wins as in tpuflow.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import tpuflow.features.hog as J
import tpuflow_torch.features.hog as T

NORM_RTOL = 1e-15


def _img(seed=0, h=40, w=52, flat=False):
    img = gaussian_filter(np.random.default_rng(seed).uniform(0, 1, (h, w)),
                          1.5)
    if flat:
        img[:, : w // 3] = 0.5  # zero descriptors: exact distance ties
    return img


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("bins", [16, 8])
def test_orientation_and_cells_bitwise(signed, bins):
    img = _img()
    jm, jo = (np.asarray(a) for a in J.orientation(jnp.asarray(img), bins,
                                                   signed))
    tm, to = (a.numpy() for a in T.orientation(_t(img), bins, signed))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(to, jo)
    assert to.dtype == np.int32 and 0 <= to.min() and to.max() < bins
    for dense in (False, True):
        want = np.asarray(J.compute_hog(jnp.asarray(jm), jnp.asarray(jo),
                                        bins, J.CELL, dense))
        got = T.compute_hog(_t(jm), _t(jo), bins, T.CELL, dense).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dense", [False, True])
def test_descriptor(dense):
    img = _img(1, 72, 90)
    jraw, jblock = (np.asarray(a) for a in J.hog_descriptor(
        jnp.asarray(img), 16, True, dense))
    traw, tblock = (a.numpy() for a in T.hog_descriptor(_t(img), 16, True,
                                                        dense))
    np.testing.assert_array_equal(traw, jraw)
    np.testing.assert_allclose(tblock, jblock, rtol=NORM_RTOL, atol=0)
    integral = np.asarray(J.block_normalize_integral(jnp.asarray(jraw)))
    np.testing.assert_array_equal(
        T.block_normalize_integral(_t(jraw)).numpy(), integral)


def test_block_normalize_errors():
    with pytest.raises(ValueError, match="too small"):
        T.block_normalize(torch.zeros(8, 20, 16))
    with pytest.raises(ValueError, match="smaller than block"):
        T.block_normalize_integral(torch.zeros(2, 20, 16))


def _descriptors(flat=False):
    _, a = J.hog_descriptor(jnp.asarray(_img(2, flat=flat)), 16, True, True)
    moved = np.roll(_img(2, flat=flat), (1, 2), (0, 1))
    _, b = J.hog_descriptor(jnp.asarray(moved), 16, True, True)
    return np.asarray(a), np.asarray(b)


@pytest.mark.parametrize("search", [(9, 7), (4, 6), (65, 65)])
@pytest.mark.parametrize("flat", [False, True])
def test_hog_matching_bitwise(search, flat):
    prv, cur = _descriptors(flat)
    want = [np.asarray(a) for a in J.hog_matching(
        jnp.asarray(prv), jnp.asarray(cur), *search)]
    got = [a.numpy() for a in T.hog_matching(_t(prv), _t(cur), *search)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if search == (9, 7) and not flat:
        # Interior sites find the (2, 1) move.
        assert (got[0][5:-5, 5:-5] == 2).mean() > 0.9
        assert (got[1][5:-5, 5:-5] == 1).mean() > 0.9


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_hog_matching_chunks(chunk):
    """The scan's result does not depend on how many offsets it takes at
    once."""
    prv, cur = _descriptors(True)
    h, w, _ = prv.shape
    offs = T.match_offsets(9, 7)
    want = T.match_scan(_t(prv), _t(cur), offs, T.match_init(h, w, _t(prv)))
    got = T.match_scan(_t(prv), _t(cur), offs, T.match_init(h, w, _t(prv)),
                       chunk=chunk)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_.numpy())


def test_match_scan_skips_sentinels():
    """An offset beyond the grid (a mesh's padding) changes no carry."""
    prv, cur = _descriptors()
    h, w, _ = prv.shape
    offs = T.match_offsets(9, 7)
    carry = T.match_init(h, w, _t(prv))
    a = T.match_scan(_t(prv), _t(cur), offs, carry)
    b = T.match_scan(_t(prv), _t(cur), offs + [(h + 1, h + 1)] * 5, carry)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
