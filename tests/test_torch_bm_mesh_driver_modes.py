"""The flagship driver with ``mesh=`` against tpuflow's in the fast
profile and in mode AFFINE, on gloo meshes of CPU ranks, through
tests/test_torch_bm_mesh_driver.py's :func:`_suite` and held as there:
labels, region counts, BM winners and time directions equal, u and v
within FLAGSHIP_ATOL (1e-6); each mesh spawned once in this file.

jax and tpuflow are imported inside the tests only.
"""

import pytest

from test_torch_bm_mesh_driver import (DEADLINE_S, MESHES, _suite,
                                       check_against_tpuflow)
from tpuflow_torch.dist import run_on_mesh

MODES = ("fast", "affine")


@pytest.fixture(scope="module", params=MESHES, ids=lambda n: f"mesh{n}")
def port(request):
    n = request.param
    return n, run_on_mesh(_suite, n, "gloo", "cpu", args=(MODES,),
                          timeout=DEADLINE_S)


def test_ranks_agree(port):
    assert port[1]["ranks_agree"]


@pytest.mark.parametrize("case", MODES)
def test_mesh_driver_matches_tpuflow(port, case):
    check_against_tpuflow(port, case)
