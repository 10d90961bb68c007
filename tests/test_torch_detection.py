"""Scratch detection, meaningful alignments and the exclusive principle:
tpuflow_torch against tpuflow on the CPU in float64.

- ``detect_scratch``: the map and the filtered frame bitwise, unfiltered
  and with the epsilon prefilter (the same elementwise operations; the
  side sums are prefix sums in XLA's CPU grouping). With the Gaussian
  prefilter the port runs the separable ``sep_conv2d_valid`` where
  tpuflow on the CPU runs XLA's 2-D convolution, so the filtered frames
  agree within 1e-12 x 255, and the decision is held bitwise on the
  same filtered frame (tpuflow's ``_detect`` on the port's).
- ``aligned_segments_vertical``, ``exclusive_principle`` and the
  probability tables: equal segment lists, index maps and tables, on
  tpuflow's angle field and through the port's own chain (scratch map,
  angles, segments) against tpuflow's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuflow.detection as J
import tpuflow_torch.detection as T
from tpuflow.core.config import FilterParam as JFilter
from tpuflow.detection.scratch import _detect as j_detect
from tpuflow.ops import derivative_angler as j_angler
from tpuflow_torch.core.config import FilterParam as TFilter
from tpuflow_torch.ops import derivative_angler as t_angler

GAUSS_ATOL = 1e-12 * 255


def _frame(seed=0, h=60, w=80):
    """Integer-valued noisy background with bright, dark and slanted
    scratches and a brightness step."""
    rng = np.random.default_rng(seed)
    img = np.round(rng.normal(100.0, 2.0, (h, w)))
    img[:, 17] += 40
    img[:, 50] -= 35
    img[:, 60:] += 80
    for y in range(h):
        img[y, 30 + y // 12] += 45
    return img


def _filters():
    eps = dataclasses.replace(JFilter().change_filter("e"), size=(7, 5))
    gauss = dataclasses.replace(JFilter().change_filter("g"), size=(9, 7),
                                std_deviation=1.5)
    return {"none": None, "epsilon": eps, "gaussian": gauss,
            "epsilon_default": JFilter().change_filter("e")}


def _port_filter(jf):
    return None if jf is None else TFilter(**dataclasses.asdict(jf))


@pytest.mark.parametrize("name", sorted(_filters()))
@pytest.mark.parametrize("thresholds", [(3.0, 20.0), (10.0, 5.0)])
def test_detect_scratch(name, thresholds):
    img = _frame()
    jf = _filters()[name]
    jmap, jfilt = (np.asarray(a) for a in J.detect_scratch(
        jnp.asarray(img), *thresholds, jf))
    tmap, tfilt = (a.numpy() for a in T.detect_scratch(
        torch.from_numpy(img), *thresholds, _port_filter(jf)))
    if name == "gaussian":
        np.testing.assert_allclose(tfilt, jfilt, rtol=0, atol=GAUSS_ATOL)
        # The decision on the same filtered frame: bitwise.
        np.testing.assert_array_equal(tmap, np.asarray(j_detect(
            jnp.asarray(tfilt), *thresholds)))
    else:
        np.testing.assert_array_equal(tfilt, jfilt)
        np.testing.assert_array_equal(tmap, jmap)
    assert set(np.unique(tmap)) <= {0.0, 255.0}
    if name == "none" and thresholds == (3.0, 20.0):
        assert (tmap[:, 17] == 255).all() and (tmap[:, 50] == 255).all()
        assert tmap[:, 58:63].max() == 0  # the step is no scratch


def test_filtered_mode_returns_the_prefilter():
    img = _frame(1)
    fp = _port_filter(_filters()["epsilon"])
    smap, filt = T.detect_scratch(torch.from_numpy(img), 3.0, 20.0, fp,
                                  do_detection=False)
    assert smap is filt
    np.testing.assert_array_equal(
        filt.numpy(), np.asarray(J.detect_scratch(
            jnp.asarray(img), 3.0, 20.0, _filters()["epsilon"],
            do_detection=False)[1]))


@pytest.mark.parametrize("p,ep", [(1.0 / 16.0, 1.0), (0.1, 0.5)])
def test_tables(p, ep):
    w, h = 80, 60
    jt, tt = J.pr_table(max(w, h), p), T.pr_table(max(w, h), p)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(T.calc_k_l(w, h, p, ep, tt),
                                  J.calc_k_l(w, h, p, ep, jt))
    assert T.l_min_for(w, h, p, ep) == J.l_min_for(w, h, p, ep)


def _angles(seed):
    smap = np.asarray(J.detect_scratch(jnp.asarray(_frame(seed)))[0])
    return smap, np.asarray(j_angler(jnp.asarray(smap)))


def _as_tuples(segs):
    return [(s.n, s.m, s.x, s.y, s.pr) for s in segs]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("lengths", [(0, 0), (20, 0), (0, 30)])
def test_aligned_segments_vertical(seed, lengths):
    _, angles = _angles(seed)
    want = J.aligned_segments_vertical(angles, None, None, None, *lengths)
    got = T.aligned_segments_vertical(angles, None, None, None, *lengths)
    assert len(want) > 0
    assert _as_tuples(got) == _as_tuples(want)
    assert all(type(s) is T.Segment for s in got)


@pytest.mark.parametrize("radius", [1.5, 3.0])
def test_exclusive_principle(radius):
    smap, angles = _angles(0)
    h, w = angles.shape
    table = J.pr_table(max(w, h))
    k_list = J.calc_k_l(w, h, table=table)
    segs = J.aligned_segments_vertical(angles)
    jsegs, jmap = J.exclusive_principle(angles, segs, k_list, table, radius)
    tsegs, tmap = T.exclusive_principle(
        angles, [T.Segment(**dataclasses.asdict(s)) for s in segs], k_list,
        table, radius)
    assert 0 < len(jsegs) <= len(segs)
    assert _as_tuples(tsegs) == _as_tuples(jsegs)
    np.testing.assert_array_equal(tmap, jmap)


def test_port_chain_matches_tpuflow():
    """Scratch map, angle field and segments all computed by the port
    equal tpuflow's chain."""
    img = _frame(2)
    smap, jangles = _angles(2)
    tmap = T.detect_scratch(torch.from_numpy(img))[0]
    np.testing.assert_array_equal(tmap.numpy(), smap)
    tangles = t_angler(tmap).numpy()
    np.testing.assert_array_equal(tangles, jangles)
    assert _as_tuples(T.aligned_segments_vertical(tangles)) == \
        _as_tuples(J.aligned_segments_vertical(jangles))
