"""The per-region affine fit against tpuflow's, on the CPU: float64
within 1e-12 and float32 within 1e-6 (the tolerances and inputs of
tests/test_torch_affine.py, whose module docstring gives the measured
errors), from zero and from a carried ``a0``, with and without a
threshold that stops some regions mid-run. Split from that file so that
the suite's files spread over its workers; the cases are unchanged.
"""

import numpy as np
import pytest
import torch

from test_torch_affine import (ATOL, ATOL_F32, N_REGIONS, _both,  # noqa: F401
                               _close, region_inputs)


@pytest.mark.parametrize("dtype,atol", [(np.float64, ATOL),
                                        (np.float32, ATOL_F32)])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("threshold", [1e-6, 40.0])
def test_affine_parametric_flow_matches(region_inputs, dtype, atol, warm,
                                        threshold):
    (a, u, v), (aj, uj, vj) = _both(
        region_inputs, dtype, warm=warm, iter_max=200, normalize_steps=True,
        error_min_threshold=threshold)
    assert a.shape == (N_REGIONS, 6) and u.dtype == torch.from_numpy(
        np.zeros(1, dtype)).dtype
    _close(u.numpy(), uj, atol)
    _close(v.numpy(), vj, atol)
    _close(a.numpy(), aj, atol)
