"""track_points' host-sync cadence, on the CPU: the port's tracking reads
its done mask every ``DONE_CHECK_EVERY`` steps, and every cadence gives
the same iterate bitwise (a done point is frozen). Split from
tests/test_torch_lucas_kanade.py, whose frames it takes, so that the
suite's files spread over its workers; the cases are unchanged.
"""

import pytest
import torch

from test_torch_lucas_kanade import _grid_points, pair  # noqa: F401
from tpuflow_torch.solvers import lucas_kanade as tl


@pytest.mark.parametrize("every", [1, 3, 1000])
def test_track_points_check_cadence_is_invisible(pair, monkeypatch, every):
    """Reading the done mask every step, every 3 or never gives the same
    iterate: a done point is frozen."""
    prev, nxt = pair
    pts = _grid_points()
    args = (torch.from_numpy(prev), torch.from_numpy(nxt), pts)
    want = tl.track_points(*args)
    monkeypatch.setattr(tl, "DONE_CHECK_EVERY", every)
    got = tl.track_points(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
