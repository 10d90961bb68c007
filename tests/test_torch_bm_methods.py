"""The block matcher's coarse, half-resolution and bf16 evaluators, and the
fast and turbo profiles, against tpuflow on the CPU.

Same float64 inputs, made with numpy from a seed, through both packages'
same method, single-direction and fused bidirectional:

- the winners (integer and subpixel displacements) equal exactly, the
  costs within the exhaustive evaluators' COST_RTOL / COST_ATOL (sums of
  the same terms in another order);
- ``matmul_bf16`` rounds the per-candidate moment fields to bfloat16 in
  both packages and sums the rounded values, tpuflow through XLA's
  bf16 dot, the port in float64: the winners equal, the integer costs
  (subpixel scale 1, where nothing re-scores them) within BF16_RTOL of
  tpuflow's relative to the cost's scale; measured 7.8e-14 at most (the
  bf16 products are exact, so only the summation order differs, and a
  flat region's ZNCC amplifies it). The inputs have no near-ties: their
  winning costs stand clear of the runner-up;
- the profiles run the flagship in float32 in both packages, held as
  tests/test_torch_bm_flow.py holds the default profile: labels, winners
  and time directions equal, u and v within FLAGSHIP_ATOL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import tpuflow.blockmatching.matcher as jm
import tpuflow.solvers.bm_flow as jb
import tpuflow_torch.blockmatching.matcher as tm
import tpuflow_torch.solvers.bm_flow as tb
from tpuflow_torch.utils.numerics import warm_cpu_sqrt
from test_torch_blockmatching import (COST_ATOL, COST_RTOL, _random_pair,
                                      _shift_pair, _subpixel_pair)
from test_torch_bm_flow import (FLAGSHIP_KW, _assert_outputs_match,  # noqa: F401
                                three_frames)

BF16_RTOL = 1e-12
NEW_METHODS = ("matmul_coarse", "matmul_coarse3", "matmul_half",
               "matmul_half2", "matmul_bf16")
warm_cpu_sqrt()  # the ZNCC's sqrt is held to COST_RTOL


def _t(a):
    return torch.from_numpy(np.array(a))


def _pairs():
    """(cur, ref, labels, n_regions, search_range, subpixel) cases: the
    exhaustive tests' three fixtures and a smooth pan of 8x8 blocks."""
    cur, ref, labels, n = _random_pair(1)
    rng = np.random.default_rng(31)
    base = gaussian_filter(rng.uniform(0, 100, (56, 80, 3)), (1.5, 1.5, 0))
    return {"random": (cur, ref, labels, n, 9, 2),
            "shift": _shift_pair(),
            "subpixel": _subpixel_pair(),
            "pan": (base[6:-2, 5:-3], base[4:-4, 4:-4],
                    jm.grid_labels(48, 72, 8),
                    int(jm.grid_labels(48, 72, 8).max()) + 1, 11, 2)}


PAIRS = _pairs()


def _want(case, method, subpixel=None):
    cur, ref, labels, n, sr, sub = PAIRS[case]
    return jm.block_matching_labels(jnp.asarray(cur), jnp.asarray(ref),
                                    labels, n, search_range=sr,
                                    subpixel_scale=sub if subpixel is None
                                    else subpixel, method=method)


def _got(case, method, subpixel=None):
    cur, ref, labels, n, sr, sub = PAIRS[case]
    return tm.block_matching_labels(_t(cur), _t(ref), labels, n,
                                    search_range=sr,
                                    subpixel_scale=sub if subpixel is None
                                    else subpixel, method=method)


def _assert_same(got, want, rtol=COST_RTOL, atol=COST_ATOL):
    np.testing.assert_array_equal(got.region_uv, want.region_uv)
    np.testing.assert_allclose(got.region_cost, want.region_cost, rtol=rtol,
                               atol=atol)
    np.testing.assert_array_equal(got.u, want.u)
    np.testing.assert_array_equal(got.v, want.v)


def test_methods_match_tpuflow_list():
    assert tm.METHODS == jm.METHODS
    assert not hasattr(tm, "_UNPORTED")


@pytest.mark.parametrize("stride", [2, 3])
@pytest.mark.parametrize("search_range", [7, 15, 61])
def test_coarse_candidates_match(search_range, stride):
    np.testing.assert_array_equal(
        tm.coarse_candidates(search_range, stride),
        jm.coarse_candidates(search_range, stride))
    for shards in (1, 4):
        want, n = jm._coarse_padded_candidates(search_range, 64, stride,
                                               shards)
        got = tm.padded_candidates(tm.coarse_candidates(search_range, stride),
                                   64, shards)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(
            tm.padded_candidates(tm.search_candidates(search_range), 64,
                                 shards),
            np.asarray(jm._padded_candidates(search_range, 64, shards)))


def test_half_res_matches():
    rng = np.random.default_rng(4)
    for shape in ((37, 53, 3), (40, 48, 3)):
        img = rng.uniform(0, 100, shape)
        np.testing.assert_array_equal(tm._half_res(_t(img)).numpy(),
                                      np.asarray(jm._half_res(
                                          jnp.asarray(img))))


@pytest.mark.parametrize("method", NEW_METHODS[:4])
@pytest.mark.parametrize("case", list(PAIRS))
def test_coarse_and_half_methods_match(case, method):
    _assert_same(_got(case, method), _want(case, method))


@pytest.mark.parametrize("case", list(PAIRS))
def test_bf16_matches(case):
    """Winners equal at the case's subpixel scale; the integer costs (no
    re-score at subpixel scale 1) within BF16_RTOL of the cost scale."""
    _assert_same(_got(case, "matmul_bf16"), _want(case, "matmul_bf16"))
    got = _got(case, "matmul_bf16", subpixel=1)
    want = _want(case, "matmul_bf16", subpixel=1)
    np.testing.assert_array_equal(got.region_uv, want.region_uv)
    scale = np.abs(want.region_cost).max()
    np.testing.assert_allclose(got.region_cost, want.region_cost, rtol=0,
                               atol=BF16_RTOL * scale)


@pytest.mark.parametrize("method", NEW_METHODS)
def test_bidirectional_matches(method):
    """The fused search over both references: each direction equals the
    port's single-direction search bitwise and tpuflow's fused search."""
    cur, ref, labels, n, sr, sub = PAIRS["pan"]
    nxt = np.roll(cur, (1, 2), (0, 1)) + 0.1
    kw = dict(search_range=sr, subpixel_scale=sub, method=method)
    gp, gn, gt = tm.block_matching_bidirectional(_t(cur), _t(ref), _t(nxt),
                                                 labels, n, **kw)
    wp, wn, wt = jm.block_matching_bidirectional(
        jnp.asarray(cur), jnp.asarray(ref), jnp.asarray(nxt), labels, n, **kw)
    _assert_same(gp, wp)
    _assert_same(gn, wn)
    np.testing.assert_array_equal(gt, wt)
    for r, refr in ((gp, ref), (gn, nxt)):
        single = tm.block_matching_labels(_t(cur), _t(refr), labels, n, **kw)
        np.testing.assert_array_equal(r.region_uv, single.region_uv)
        np.testing.assert_array_equal(r.region_cost, single.region_cost)


def test_half_invisible_region_reseeds_at_zero():
    """tests/test_bm_flow.py:1126: a one-pixel region at odd coordinates
    has no sample on the half-resolution grid, so every coarse cost is
    inf; its refinement starts at zero and finds the exact match there.
    That region's ZNCC is the moment form's rounding noise (a one-pixel
    variance, clamped), which the port's float64 sums of float32 fields
    round otherwise than tpuflow's float32 sums, so only the large
    region's cost is held to tpuflow's."""
    rng = np.random.default_rng(34)
    h, w = 32, 48
    frame = rng.uniform(0.2, 0.8, (h, w, 3)).astype(np.float32)
    labels = np.zeros((h, w), np.int32)
    labels[5, 7] = 1
    kw = dict(search_range=9, subpixel_scale=2, method="matmul_half")
    got = tm.block_matching_labels(_t(frame), _t(frame), labels, 2, **kw)
    want = jm.block_matching_labels(jnp.asarray(frame), jnp.asarray(frame),
                                    labels, 2, **kw)
    assert np.isfinite(got.region_cost).all()
    np.testing.assert_allclose(got.region_uv[1], [0.0, 0.0])
    np.testing.assert_array_equal(got.region_uv, want.region_uv)
    np.testing.assert_allclose(got.region_cost[0], want.region_cost[0],
                               rtol=1e-6)


# -- the fast and turbo profiles through the flagship -------------------------

@pytest.mark.parametrize("profile", ["fast", "turbo"])
def test_flagship_profile_matches(three_frames, profile):
    f0, f1, f2 = three_frames
    kw = dict(FLAGSHIP_KW, profile=profile)
    want1, wstate = jb.optical_flow_block_matching(f0, f1, **kw)
    want2, _ = jb.optical_flow_block_matching(f1, f2, state=wstate, **kw)
    got1, state = tb.optical_flow_block_matching(f0, f1, device="cpu", **kw)
    got2, _ = tb.optical_flow_block_matching(f1, f2, state=state,
                                             device="cpu", **kw)
    _assert_outputs_match(got1, want1)
    _assert_outputs_match(got2, want2)
    assert got2.bidirectional
