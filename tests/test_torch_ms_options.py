"""The mean-shift filter's options and its tile entry against tpuflow, on
the CPU.

- ``with_drift`` and ``return_trajectory`` through the port's filter (its
  plain version on CPU tensors) against tpuflow's jnp filter at float64,
  on frames within the drift contract (tpuflow's own certificate is
  asserted first): positions, colours, the largest drift and the
  trajectory agree to atol 1e-12, i.e. bitwise up to nothing coarser
  (the two sweep other windows whose extra offsets weigh exactly 0).
- ``segment_meanshift(margin="auto")``: where the R/2 certificate holds
  (one filter run) and where it fails (a second run at the full margin),
  labels, region count and positions equal tpuflow's.
- The tile entry's plain version on each tile of a 2x2 cut, halo'd by E
  with the sentinel outside the frame, equals the whole-frame filter's
  window exactly (also at windows that reach past the frame).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import tpuflow.segmentation.meanshift as jms
import tpuflow_torch.segmentation.meanshift as tms
from tpuflow_torch.kernels import ms_filter

ATOL = 1e-12


def _smooth_lab(shape, seed, sigma=2.0):
    """Smooth colour field: its modes drift little (in contract)."""
    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.uniform(0, 1, shape), (sigma, sigma, 0))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("R,ki,iters,margin", [(4, 0.12, 3, None),
                                               (3, 0.2, 4, 3),
                                               (5, 0.1, 2, None)])
def test_drift_and_trajectory_match(R, ki, iters, margin):
    lab = _smooth_lab((24, 36, 3), 7)
    want = jms.mean_shift_filter(jnp.asarray(lab), R, ki, iters, margin,
                                 with_drift=True, return_trajectory=True)
    assert float(want[2]) <= (R if margin is None else margin)
    got = tms.mean_shift_filter(torch.from_numpy(lab), R, ki, iters, margin,
                                with_drift=True, return_trajectory=True)
    assert len(got) == 4 and got[2].dim() == 0
    assert got[3].shape == (iters, 24, 36, 2)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    # Either option alone: the same values in tpuflow's positions.
    drift_only = tms.mean_shift_filter(torch.from_numpy(lab), R, ki, iters,
                                       margin, with_drift=True)
    traj_only = tms.mean_shift_filter(torch.from_numpy(lab), R, ki, iters,
                                      margin, return_trajectory=True)
    assert len(drift_only) == len(traj_only) == 3
    np.testing.assert_array_equal(drift_only[2].numpy(), got[2].numpy())
    np.testing.assert_array_equal(traj_only[2].numpy(), got[3].numpy())


def _count_filter_runs(monkeypatch):
    runs = []
    real = tms.mean_shift_filter

    def counted(*args, **kwargs):
        runs.append(kwargs.get("margin", args[4] if len(args) > 4 else None))
        return real(*args, **kwargs)

    monkeypatch.setattr(tms, "mean_shift_filter", counted)
    return runs


@pytest.mark.parametrize("case", ["certificate_holds", "certificate_fails"])
def test_auto_margin_matches(case, monkeypatch):
    """R = 6: the fast pass runs at margin 3. On random colours a colour
    radius of 0.05 keeps every mode within 3 px (largest drift 2.69); at
    0.1 modes drift past it (5.19), but within R, so tpuflow's
    full-margin retry is in contract too."""
    R = 6
    ki = 0.05 if case == "certificate_holds" else 0.1
    lab = np.random.default_rng(1).uniform(0, 1, (20, 30, 3))
    drift = float(jms.mean_shift_filter(jnp.asarray(lab), R, ki, 8,
                                        margin=R // 2, with_drift=True)[2])
    assert (drift <= R // 2) == (case == "certificate_holds")
    full = jms.mean_shift_filter(jnp.asarray(lab), R, ki, 8, with_drift=True)
    assert float(full[2]) <= R
    runs = _count_filter_runs(monkeypatch)
    got = tms.segment_meanshift(torch.from_numpy(lab), R, ki, margin="auto")
    want = jms.segment_meanshift(lab, R, ki, margin="auto")
    assert runs == ([R // 2] if case == "certificate_holds"
                    else [R // 2, None])
    assert got.n_regions == want.n_regions
    np.testing.assert_array_equal(got.labels, want.labels)
    _close(got.shift_spatial, want.shift_spatial)
    _close(got.shift_color, want.shift_color)


def test_auto_margin_small_kernel_takes_full_margin(monkeypatch):
    """R <= 2 has no smaller margin to try: one run at the full margin."""
    lab = _smooth_lab((12, 16, 3), 9)
    runs = _count_filter_runs(monkeypatch)
    got = tms.segment_meanshift(torch.from_numpy(lab), 2, 0.2, margin="auto")
    want = jms.segment_meanshift(lab, 2, 0.2, margin="auto")
    assert runs == [None]
    np.testing.assert_array_equal(got.labels, want.labels)


def _tile_cut(lab, E, ki):
    """The 2x2 cut's tiles, each halo'd by E with the sentinel outside the
    frame, and their cores' frame origins."""
    h, w = lab.shape[:2]
    th, tw = h // 2, w // 2
    sentinel = tms._color_sentinel(lab, ki)
    padded = ms_filter._padded_planes(lab, E, sentinel).permute(1, 2, 0)
    for i in range(2):
        for k in range(2):
            row0, col0 = i * th, k * tw
            yield (padded[row0 : row0 + th + 2 * E,
                          col0 : col0 + tw + 2 * E].contiguous(),
                   row0, col0)


@pytest.mark.parametrize("R,ki,iters,margin", [(4, 0.12, 3, None),
                                               (3, 0.3, 2, 6)])
def test_tile_entry_equals_whole_frame(R, ki, iters, margin):
    """Random colours (many queries out of contract, empty windows that
    jump to the frame origin) and a window E that reaches past a tile."""
    lab = torch.from_numpy(np.random.default_rng(11).uniform(0, 1,
                                                             (20, 28, 3)))
    E = ms_filter.window(R, margin)
    pos, col = tms.mean_shift_filter(lab, R, ki, iters, margin)
    th, tw = 10, 14
    for tile, row0, col0 in _tile_cut(lab, E, ki):
        for fn in (ms_filter.mean_shift_filter_tile_plain,
                   ms_filter.mean_shift_filter_tile):
            p, c = fn(tile, row0, col0, E, R, ki, iters)
            np.testing.assert_array_equal(
                p.numpy(), pos[row0 : row0 + th, col0 : col0 + tw].numpy())
            np.testing.assert_array_equal(
                c.numpy(), col[row0 : row0 + th, col0 : col0 + tw].numpy())


def test_tile_entry_rejects_a_tile_without_core():
    with pytest.raises(ValueError, match="no core"):
        ms_filter.mean_shift_filter_tile(torch.zeros((8, 8, 3)), 0, 0, 4,
                                         2)
