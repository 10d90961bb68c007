"""The frozen roofline arithmetic against counts made by hand."""

import numpy as np
import pytest
import torch

from flowbench import bounds


def test_irls_bound_hand_count():
    # 2x3 frame: 2*2 horizontal + 1*3 vertical edges; 20 ops a pixel and
    # 16 an edge per sweep; 7 fields of 4 bytes read or written once.
    ops = 3 * (20 * 6 + 16 * 7)
    assert bounds.irls_bound((2, 3), 3) == max(
        7 * 4 * 6 / bounds.PEAK_BYTES_PER_S, ops / bounds.PEAK_F32_PER_S)


def test_gated_bound_hand_count():
    labels = np.array([[0, 0, 1], [0, 1, 1]])
    # same-region edges: rows (0,0)-(0,1), (1,1)-(1,2); columns
    # (0,0)-(1,0), (0,2)-(1,2)
    assert bounds.same_region_edges(labels) == 4
    ops = 5 * 2 * (26 * 6 + 29 * 4)
    assert bounds.gated_bound(6, 4, 5, 2) == max(
        4 * 6 * (5 * 2 + 3) / bounds.PEAK_BYTES_PER_S,
        ops / bounds.PEAK_F32_PER_S)


@pytest.mark.parametrize("launches,sweeps", [(1, 1), (5, 65), (9, 129),
                                             (129, 2048)])
def test_gated_sweeps_of_launches(launches, sweeps):
    # the refine's schedule: 1 sweep, then blocks of 64 in launches of 16
    assert bounds.gated_sweeps_of_launches(launches, 2048) == sweeps


def test_gated_sweeps_refuses_a_count_off_the_schedule():
    with pytest.raises(ValueError):
        bounds.gated_sweeps_of_launches(3, 2048)


def test_ms_bound_hand_count():
    assert bounds.ms_disc(1) == 5
    assert bounds.ms_disc(20) == 1257
    # 2 queries x 3 iterations at R = 1: 13 per offset of the 5-point
    # disc, 2 per disc row (3 rows); 8 floats of 4 bytes a query.
    assert bounds.ms_bound(2, 1, 6) == max(
        4 * 8 * 2 / bounds.PEAK_BYTES_PER_S,
        6 * (13 * 5 + 2 * 3) / bounds.PEAK_F32_PER_S)


def test_ms_query_iterations_counts_until_a_state_repeats():
    a = torch.tensor([[1, 1], [5, 5], [7, 7]], dtype=torch.int32)
    b = torch.tensor([[2, 1], [5, 5], [8, 7]], dtype=torch.int32)
    c = torch.tensor([[2, 1], [5, 5], [9, 7]], dtype=torch.int32)
    # query 0 repeats at iteration 2, query 1 at 1, query 2 never: 3
    assert bounds.ms_query_iterations([a, b, c, c]) == 2 + 1 + 3
