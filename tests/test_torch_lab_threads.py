"""The flagship's host Lab conversion does not depend on the torch thread
count, and stays tpuflow's on the CPU.

PyTorch's vectorized CPU ``pow`` rounds the last elements of each
thread's share through the scalar routine; at one thread 96 pixels of the
376x1240 Voronoi middle frame came out up to 3.6e-7 off the many-thread
result, so a mesh rank (one thread) and the launching process segmented
other bits. The Lab ``pow`` branches now split the CPU work at fixed
points (``numerics.pow_fixed_split``): ``bm_flow._to_lab`` gives the same
bits at every thread count (checked bitwise, without touching the thread
count inside the conversion), and stays within atol 1e-6 of tpuflow's
float32 conversion (Lab channels are at most ~1; the two packages'
float32 pow differ in the last bits). ``pow_fixed_split`` itself is held
bitwise to one thread's ``x ** p`` at sizes around its chunk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpuflow.core.color import srgb_to_lab as j_srgb_to_lab
from tpuflow_torch.solvers.bm_flow import _to_lab
from tpuflow_torch.utils.numerics import POW_CHUNK, pow_fixed_split


@pytest.fixture(scope="module")
def middle_frame():
    return chip_smoke.voronoi_frames()[0][1]


@pytest.mark.parametrize("threads", [2, 3, 8])
def test_to_lab_equals_one_thread_result(middle_frame, threads):
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        norm1, lab1 = _to_lab(middle_frame, 255.0)
        assert torch.get_num_threads() == 1
        torch.set_num_threads(threads)
        norm, lab = _to_lab(middle_frame, 255.0)
        assert torch.get_num_threads() == threads
    finally:
        torch.set_num_threads(before)
    assert lab.shape == (376, 1240, 3) and lab.dtype == torch.float32
    assert torch.equal(norm, norm1)
    assert torch.equal(lab, lab1)


def test_to_lab_matches_tpuflow(middle_frame):
    _, lab = _to_lab(middle_frame, 255.0)
    want = np.asarray(j_srgb_to_lab(
        jnp.asarray(middle_frame, jnp.float32) / 255.0))
    np.testing.assert_allclose(lab.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [POW_CHUNK - 1, POW_CHUNK + 1,
                                  3 * POW_CHUNK + 7, 376 * 1240 * 3])
@pytest.mark.parametrize("p", [2.4, 1.0 / 3.0])
def test_pow_fixed_split_is_one_thread_pow(size, p):
    x = torch.from_numpy(
        np.random.default_rng(size).uniform(0.0, 1.0, size).astype(np.float32))
    before = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        want = x ** p
        for threads in (1, 3, 8):
            torch.set_num_threads(threads)
            got = pow_fixed_split(x.view(-1, 1), p)
            assert got.shape == (size, 1)
            assert torch.equal(got.view(-1), want), threads
    finally:
        torch.set_num_threads(before)
