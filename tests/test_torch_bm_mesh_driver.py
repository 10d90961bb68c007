"""The flagship driver with ``mesh=`` against tpuflow's, on gloo meshes
of CPU ranks.

Each mesh (1x2 and 2x2) is spawned once per file, through
``run_on_mesh``, in a module-scoped fixture: every rank runs
``optical_flow_block_matching`` over the same three frames
(tests/test_torch_bm_flow.py's Voronoi pan at 40x56) in the default mode
here, with ``profile="fast"`` and in mode AFFINE in
tests/test_torch_bm_mesh_driver_modes.py (through this :func:`_suite`);
rank 0 returns its outputs, and every rank's labels and flows are
checked equal to rank 0's. tpuflow's driver runs the same calls with
``mesh=make_mesh(n)`` on the 8-device virtual CPU mesh. Both run in
float32, so they are held as tests/test_torch_bm_flow.py holds the
single-device driver: labels, region counts, BM winners and time
directions equal, u and v within FLAGSHIP_ATOL (1e-6).

jax and tpuflow are imported inside the tests only: the spawned ranks
import this module to find :func:`_suite`.
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.core.config import MODE_OUTPUT_AFFINE_BLOCKMATCHING
from tpuflow_torch.dist import run_on_mesh

MESHES = (2, 4)
DEADLINE_S = 300.0
FLAGSHIP_ATOL = 1e-6
KW = dict(search_range=7, kernel_spatial=8, iter_max=130)
CASES = {"default": {}, "fast": {"profile": "fast"},
         "affine": {"mode": MODE_OUTPUT_AFFINE_BLOCKMATCHING}}
FIELDS = ("u", "v", "t", "bm_u", "bm_v", "quantized_rgb", "shift_vector")


def _frames():
    from chip_smoke import voronoi_frames

    frames, _ = voronoi_frames((40, 56), cells_per_px=150 / (56 * 72),
                               pan=(1, 2), shade=1.875, seed=1)
    return frames


def _out(o) -> dict:
    d = {k: np.asarray(getattr(o, k)) for k in FIELDS}
    d["labels"] = o.segmentation.labels
    d["n_regions"] = o.segmentation.n_regions
    d["bidirectional"] = o.bidirectional
    return d


def _suite(mesh, cases) -> dict:
    """The driver's two pairs in each of ``cases`` (keys of CASES)."""
    import torch.distributed as dist

    from tpuflow_torch.solvers.bm_flow import optical_flow_block_matching

    f0, f1, f2 = _frames()
    out = {}
    for name in cases:
        kw = dict(KW, **CASES[name])
        o1, state = optical_flow_block_matching(f0, f1, mesh=mesh, **kw)
        o2, _ = optical_flow_block_matching(f1, f2, state=state, mesh=mesh,
                                            **kw)
        out[name] = (_out(o1), _out(o2))
    # Every rank's labels and flows equal rank 0's.
    digest = torch.tensor([float(np.sum(out[c][k]["labels"] * (1 + k)))
                           + float(np.sum(out[c][k]["u"]))
                           for c in cases for k in (0, 1)],
                          dtype=torch.float64)
    every = [torch.empty_like(digest) for _ in range(mesh.size)]
    dist.all_gather(every, digest, group=mesh.group)
    out["ranks_agree"] = all(torch.equal(e, digest) for e in every)
    return out


@pytest.fixture(scope="module", params=MESHES, ids=lambda n: f"mesh{n}")
def port(request):
    n = request.param
    return n, run_on_mesh(_suite, n, "gloo", "cpu", args=(("default",),),
                          timeout=DEADLINE_S)


def test_ranks_agree(port):
    assert port[1]["ranks_agree"]


def check_against_tpuflow(port, case):
    import tpuflow.solvers.bm_flow as jb
    from tpuflow.dist import make_mesh

    n, out = port
    f0, f1, f2 = _frames()
    kw = dict(KW, **CASES[case])
    mesh = make_mesh(n)
    w1, state = jb.optical_flow_block_matching(f0, f1, mesh=mesh, **kw)
    w2, _ = jb.optical_flow_block_matching(f1, f2, state=state, mesh=mesh,
                                           **kw)
    for got, want in zip(out[case], (_out(w1), _out(w2))):
        assert got["n_regions"] == want["n_regions"]
        assert got["bidirectional"] == want["bidirectional"]
        for k in ("labels", "t", "bm_u", "bm_v", "quantized_rgb"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("u", "v"):
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=FLAGSHIP_ATOL, err_msg=k)
        np.testing.assert_allclose(got["shift_vector"], want["shift_vector"],
                                   rtol=0, atol=1e-4)
    assert out[case][1]["bidirectional"]


def test_mesh_driver_matches_tpuflow(port):
    check_against_tpuflow(port, "default")
