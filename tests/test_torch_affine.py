"""tpuflow_torch's affine fits against tpuflow's, on the CPU.

- The global fit (``solvers.affine``: ``affine_flow_field``,
  ``affine_energy``, ``irls_affine_level``, ``multiple_motion_affine``) in
  float64: atol 1e-12 x max(1, max|reference|) on a, E and the fields
  (measured 6.7e-16; the port sums the frame in float64 in another
  order), n equal. One case stops mid-level on E < threshold, so the
  freeze of (a, E, n) after the stop is held to tpuflow's stopping
  iterate, whatever the cadence at which the host reads the stop flag.
- The per-region fit (``bm_flow._irls_affine_regions`` through
  ``affine_parametric_flow``), on 16 regions with a BM warp, from zero
  and from a carried ``a0``:
  - with tpuflow's stabilized step (``normalize_steps=True``, the
    flagship's) for 200 iterations: float64 within 1e-12 (measured
    4.4e-16), float32 within 1e-6 (measured 1.8e-7: tpuflow sums the
    regions in float32, the port in float64 cast back), both with and
    without a threshold that stops some regions mid-run;
  - with the reference's step (``normalize_steps=False``) for 3
    iterations, float64 within 1e-12 (measured 4.8e-15). That step
    overshoots by about the region size (tpuflow's docstring), and the
    iteration amplifies last-bit differences: without a warp, on 13x13-px
    regions the two packages' fields part by 2e-8 px after 20 iterations
    and by 2.5 px after 300, on 2x2-px regions by 0.11 px after 300, so
    longer runs are compared only to themselves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import tpuflow.solvers.affine as ja
import tpuflow.solvers.bm_flow as jb
from tpuflow.core.config import MultipleMotionParam as JParam
import tpuflow_torch.solvers.affine as ta
import tpuflow_torch.solvers.bm_flow as tb
from tpuflow_torch.core.config import MultipleMotionParam
from tpuflow_torch.solvers import affine_flow_field, multiple_motion_affine

ATOL = 1e-12
ATOL_F32 = 1e-6


def _close(got, want, atol=ATOL):
    want = np.asarray(want)
    bound = atol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=bound)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def level_fields():
    rng = np.random.default_rng(5)
    gx, gy = rng.normal(size=(30, 40)), rng.normal(size=(30, 40))
    return gx, gy, 0.1 * rng.normal(size=(30, 40))


def test_affine_flow_field_and_energy_match(level_fields):
    a = np.array([1.0, 0.5, -0.25, 2.0, 0.0, 0.1])
    u, v = affine_flow_field(torch.from_numpy(a), 4, 5)
    assert float(u[2, 3]) == 1.0 + 0.5 * 3 - 0.25 * 2
    assert float(v[2, 3]) == 2.0 + 0.1 * 2
    uj, vj = ja.affine_flow_field(jnp.asarray(a), 30, 40)
    u, v = affine_flow_field(torch.from_numpy(a), 30, 40)
    assert np.array_equal(u.numpy(), np.asarray(uj))
    assert np.array_equal(v.numpy(), np.asarray(vj))
    _close(ta.affine_energy(*_t(0.01 * a, *level_fields), 0.17),
           ja.affine_energy(jnp.asarray(0.01 * a),
                            *map(jnp.asarray, level_fields), 0.17))


# E starts at 60.853 on these fields and falls to 60.803 in 200 iterations.
@pytest.mark.parametrize("threshold,stops", [(1e-6, False), (60.83, True),
                                             (1e9, True)])
@pytest.mark.parametrize("every", [1, 7, 64])
def test_irls_affine_level_matches(level_fields, monkeypatch, threshold,
                                   stops, every):
    monkeypatch.setattr(ta, "STOP_CHECK_EVERY", every)
    a0 = np.array([1e-3, 0.0, 1e-5, -1e-3, 2e-5, 0.0])
    a, E, n = ta.irls_affine_level(*_t(a0, *level_fields), 0.17, 200,
                                   threshold)
    aj, Ej, nj = ja.irls_affine_level(jnp.asarray(a0),
                                      *map(jnp.asarray, level_fields), 0.17,
                                      200, threshold)
    assert int(n) == int(nj) and (int(n) < 200) == stops
    if threshold == 60.83:
        assert 1 < int(n) < 200  # stopped mid-level
    _close(a.numpy(), aj)
    _close(E.numpy(), Ej)


def test_irls_affine_level_zero_iterations(level_fields):
    a0 = np.zeros(6)
    a, E, n = ta.irls_affine_level(*_t(a0, *level_fields), 0.17, 0, 1e-6)
    assert int(n) == 0 and float(E) == np.inf and not a.any()


def _translated(seed=3):
    """tests/test_affine.py's pair: heavily smoothed noise, shifted."""
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.uniform(0, 255, (100, 130)), 4.0)
    return base[8:-8, 8:-8], base[9:-7, 6:-10]


@pytest.mark.parametrize("level", [0, 3])
def test_multiple_motion_affine_matches(level):
    prev, nxt = _translated()
    a = multiple_motion_affine(*_t(prev, nxt), 255.0,
                               MultipleMotionParam(level=level))
    aj = ja.multiple_motion_affine(jnp.asarray(prev), jnp.asarray(nxt),
                                   255.0, JParam(level=level))
    assert a.shape == (6,) and a.dtype == torch.float64
    _close(a.numpy(), aj)


def test_multiple_motion_affine_recovers_direction():
    """tests/test_affine.py's check: direction and the exact 2:-1 ratio."""
    prev, nxt = _translated()
    a = multiple_motion_affine(*_t(prev, nxt), 255.0,
                               MultipleMotionParam(level=3)).numpy()
    h, w = prev.shape
    u_c = a[0] + a[1] * (w / 2) + a[2] * (h / 2)
    v_c = a[3] + a[4] * (w / 2) + a[5] * (h / 2)
    assert 0.5 < u_c <= 2.5 and -1.5 <= v_c < -0.2
    assert abs(u_c + 2.0 * v_c) < 0.3


# -- the per-region fit --------------------------------------------------------

N_REGIONS = 16


@pytest.fixture(scope="module")
def region_inputs():
    """Lab-like frames of smoothed noise, the interest frame's content
    moved by (-1, 0), 4x4 regions of 13x18 px, each with its own integer
    BM vector in {-1, 0, 1}^2."""
    rng = np.random.default_rng(8)
    base = gaussian_filter(rng.uniform(0, 1, (60, 80)), 3)

    def lab(g):
        return np.stack([g, 0.5 * g + 0.2, 0.3 * g - 0.1], -1)

    labels = (np.arange(52)[:, None] // 13 * 4
              + np.arange(72)[None, :] // 18).astype(np.int32)
    mv = rng.integers(-1, 2, (N_REGIONS, 2)).astype(np.float64)[labels]
    a0 = 0.01 * rng.normal(size=(N_REGIONS, 6))
    return (lab(base[4:-4, 4:-4]), lab(base[4:-4, 5:-3]), mv[..., 0],
            mv[..., 1], labels, a0)


def _both(inputs, dtype, **kw):
    ref, interest, mv_u, mv_v, labels, a0 = inputs
    if kw.pop("warm", False):
        kw["a0"] = a0.astype(dtype)
    arrays = [q.astype(dtype) for q in (ref, interest, mv_u, mv_v)]
    got = tb.affine_parametric_flow(*_t(*arrays), labels, N_REGIONS, **kw)
    want = jb.affine_parametric_flow(
        *map(jnp.asarray, arrays), labels, N_REGIONS,
        **{k: (jnp.asarray(v) if k == "a0" else v) for k, v in kw.items()})
    return got, want


def test_affine_regions_stop_mid_run(region_inputs):
    """At threshold 40 some regions stop after more than one iteration
    and before the last: their fields differ from both runs."""
    def run(**kw):
        return _both(region_inputs, np.float64, normalize_steps=True,
                     **kw)[0][1].numpy()

    free = run(iter_max=200)
    stopped = run(iter_max=200, error_min_threshold=40.0)
    first = run(iter_max=1)
    labels = region_inputs[4]
    mid = [r for r in range(N_REGIONS)
           if not np.allclose(stopped[labels == r], free[labels == r])
           and not np.allclose(stopped[labels == r], first[labels == r])]
    assert mid


@pytest.mark.parametrize("warm", [False, True])
def test_affine_parametric_reference_step_matches(region_inputs, warm):
    (a, u, v), (aj, uj, vj) = _both(region_inputs, np.float64, warm=warm,
                                    iter_max=3, normalize_steps=False)
    _close(u.numpy(), uj)
    _close(v.numpy(), vj)
    _close(a.numpy(), aj)


def test_affine_regions_check_cadence_is_invisible(region_inputs,
                                                   monkeypatch):
    """Reading the all-done flag every iteration or every 16 gives the
    same parameters (done regions are frozen); every region done stops
    the loop early."""
    kw = dict(iter_max=300, normalize_steps=True, error_min_threshold=1e9)
    want = _both(region_inputs, np.float64, **kw)[0]
    monkeypatch.setattr(tb, "AFFINE_CHECK_EVERY", 1)
    got = _both(region_inputs, np.float64, **kw)[0]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_affine_parametric_recovers_translation():
    """tests/test_bm_flow.py's stabilized-step case: one region, content
    moved by (-1, 0), 3000 iterations."""
    rng = np.random.default_rng(8)
    base = gaussian_filter(rng.uniform(0, 1, (60, 80)), 3)
    mk = lambda g: torch.from_numpy(np.stack([g] * 3, -1))  # noqa: E731
    z = torch.zeros((52, 72), dtype=torch.float64)
    a, u, v = tb.affine_parametric_flow(
        mk(base[4:-4, 4:-4]), mk(base[4:-4, 5:-3]), z, z,
        np.zeros((52, 72), np.int32), 1, iter_max=3000,
        normalize_steps=True)
    assert a.shape == (1, 6)
    assert abs(float(u[10:-10, 10:-10].median()) - 1.0) < 0.5
