"""The flagship's sharded search and filter (``tpuflow_torch.dist.bm``,
``segmentation.mean_shift_filter_sharded``) against ``tpuflow.dist``, on
gloo meshes of CPU ranks; tests/test_torch_bm_mesh_refine.py holds the
sharded refines and affine fit through the same :func:`_suite`.

Each mesh (1x2 and 2x2) is spawned once per file, through
``run_on_mesh``, in a module-scoped fixture: every rank runs the file's
parts of :func:`_suite` in float64 and rank 0 returns numpy results; the
same seeded inputs go through tpuflow.dist on ``make_mesh(n)`` of the
8-device virtual CPU mesh (tests/conftest.py), in this process.
Tolerances:

- the candidate-parallel search, every method: bitwise the port's
  single-device search (winners and costs), as tpuflow's
  tests/test_dist.py:505-590 holds its own; against tpuflow.dist the
  winners equal and the costs within the matcher tests' COST_RTOL /
  COST_ATOL;
- the sharded filter: bitwise the port's single-device filter, and
  within 1e-12 of tpuflow's sharded filter.

jax and tpuflow are imported inside the tests only: the spawned ranks
import this module to find :func:`_suite`.
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.dist import run_on_mesh

MESHES = (2, 4)
ATOL = 1e-10
COST_RTOL, COST_ATOL = 1e-10, 1e-12
DEADLINE_S = 300.0
METHODS = ("matmul", "matmul_bf16", "matmul_coarse", "matmul_coarse3",
           "matmul_half", "matmul_half2", "gather")
SEARCH = 11
MS = (4, 0.12, 3)  # R, colour radius, iterations
REFINE_ITERS = 130


def _inputs() -> dict:
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(21)
    base = gaussian_filter(rng.uniform(0, 100, (56, 80, 3)), (1.5, 1.5, 0))
    cur, ref = base[6:-2, 5:-3], base[4:-4, 4:-4]
    labels = (np.arange(48)[:, None] // 8 * 9
              + np.arange(72)[None, :] // 8).astype(np.int32)
    r = np.random.default_rng(22)
    ms_lab = gaussian_filter(r.uniform(0, 1, (24, 36, 3)), (2, 2, 0))
    # The refines: Lab frames normalized by 100 (the refine takes L * 100),
    # labels of blocks and a few strays, a small integer BM field.
    r = np.random.default_rng(23)
    f = gaussian_filter(r.uniform(0, 1, (28, 44, 3)), (2, 2, 0))
    interest, refp, refn = f[2:-2, 2:-2], f[:-4, 1:-3], f[3:-1, 4:]
    rlab = (np.arange(24)[:, None] // 6 * 5
            + np.arange(40)[None, :] // 9).astype(np.int32)
    rlab[r.uniform(size=rlab.shape) < 0.05] = 19
    mv = r.integers(-2, 3, (24, 40, 2)).astype(np.float64)
    return {"cur": cur, "ref": ref, "nxt": np.roll(cur, (1, 2), (0, 1)) + 0.1,
            "labels": labels, "n": int(labels.max()) + 1, "ms_lab": ms_lab,
            "interest": interest, "refp": refp, "refn": refn, "rlab": rlab,
            "rn": int(rlab.max()) + 1, "mv": mv, "mv2": mv[::-1, ::-1].copy()}


REFINE_CASES = {  # key -> (bidirectional, with mv, sup_mode, plateau)
    "refine": (False, False, "reference", 0.0),
    "refine_mv": (False, True, "reference", 0.0),
    "refine_bidi": (True, False, "analytic", 1e-3),
    "refine_bidi_mv": (True, True, "reference", 0.0),
}


def _suite(mesh, parts) -> dict:
    """The cases of ``parts`` ("search", "filter", "refine", "affine") on
    this rank's mesh; numpy results (rank 0's are kept)."""
    import torch.distributed as dist

    from tpuflow_torch.blockmatching import matcher
    from tpuflow_torch.dist import bm, bm_refine
    from tpuflow_torch.segmentation import meanshift

    x = _inputs()
    t = torch.from_numpy
    out = {}
    for method in METHODS if "search" in parts else ():
        r = bm.block_matching_labels_sharded(
            t(x["cur"]), t(x["ref"]), x["labels"], x["n"], mesh,
            search_range=SEARCH, method=method)
        out[method] = (r.region_uv, r.region_cost)
        bidi = bm._match_device_sharded_bidirectional(
            t(x["cur"]), t(x["ref"]), t(x["nxt"]),
            matcher.region_plan(x["labels"], x["n"], mesh.device), mesh,
            SEARCH, 1.0, 0.5, 2, 16, method)
        out[method + "_bidi"] = [(uv.numpy(), c.numpy()) for uv, c in bidi]
    if "filter" in parts:
        out["ms"] = [a.numpy() for a in meanshift.mean_shift_filter_sharded(
            t(x["ms_lab"]), mesh, *MS)]
    inter, refp, refn = t(x["interest"]), t(x["refp"]), t(x["refn"])
    mvs = [t(x["mv"]), t(x["mv2"])]
    refines = REFINE_CASES if "refine" in parts else {}
    for key, (bidi, with_mv, sup, plateau) in refines.items():
        kw = dict(iter_max=REFINE_ITERS, sup_mode=sup, plateau_rtol=plateau)
        if bidi:
            pairs, trace = bm_refine.gradient_method_flow_sharded_bidirectional(
                [refp, refn], inter, x["rlab"], mesh,
                mvs=mvs if with_mv else None, **kw)
            out[key] = ([(u.numpy(), v.numpy()) for u, v in pairs],
                        trace.numpy())
        else:
            u, v, trace = bm_refine.gradient_method_flow_sharded(
                refp, inter, x["rlab"], mesh, mv=mvs[0] if with_mv else None,
                **kw)
            out[key] = ([(u.numpy(), v.numpy())], trace.numpy()[None])
    for normalize in (True, False) if "affine" in parts else ():
        a, u, v = bm_refine.affine_parametric_flow_sharded(
            refp, inter, mvs[0][..., 0], mvs[0][..., 1], x["rlab"], x["rn"],
            mesh, iter_max=20 if normalize else 3,
            normalize_steps=normalize, max_displacement=3)
        out[f"affine_{normalize}"] = (a.numpy(), u.numpy(), v.numpy())
    # Every rank holds rank 0's results.
    mine = torch.tensor([float(np.nansum(np.asarray(a, dtype=np.float64)))
                         for a in _arrays(out)], dtype=torch.float64)
    every = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(every, mine, group=mesh.group)
    out["ranks_agree"] = all(torch.equal(e, mine) for e in every)
    return out


def _arrays(out):
    """Every array of a result, in a fixed order."""
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _arrays(out[k])]
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _arrays(o)]
    return [out]


@pytest.fixture(scope="module", params=MESHES, ids=lambda n: f"mesh{n}")
def port(request):
    n = request.param
    return n, run_on_mesh(_suite, n, "gloo", "cpu",
                          args=(("search", "filter"),), timeout=DEADLINE_S)


def test_ranks_agree(port):
    assert port[1]["ranks_agree"]


@pytest.mark.parametrize("method", METHODS)
def test_sharded_search_matches(port, method):
    import jax.numpy as jnp

    import tpuflow.dist.bm as jbm
    from tpuflow.dist import make_mesh
    from tpuflow_torch.blockmatching import matcher

    n, out = port
    x = _inputs()
    t = torch.from_numpy
    uv, cost = out[method]
    single = matcher.block_matching_labels(t(x["cur"]), t(x["ref"]),
                                           x["labels"], x["n"],
                                           search_range=SEARCH, method=method)
    np.testing.assert_array_equal(uv, single.region_uv)
    np.testing.assert_array_equal(cost, single.region_cost)
    want = jbm.block_matching_labels_sharded(
        jnp.asarray(x["cur"]), jnp.asarray(x["ref"]), x["labels"], x["n"],
        make_mesh(n), search_range=SEARCH, method=method)
    np.testing.assert_array_equal(uv, want.region_uv)
    np.testing.assert_allclose(cost, want.region_cost, rtol=COST_RTOL,
                               atol=COST_ATOL)
    pair = matcher._match_device_bidirectional(
        t(x["cur"]), t(x["ref"]), t(x["nxt"]),
        matcher.region_plan(x["labels"], x["n"], "cpu"), SEARCH, 1.0, 0.5, 2,
        16, method)
    for (g_uv, g_c), (w_uv, w_c) in zip(out[method + "_bidi"], pair):
        np.testing.assert_array_equal(g_uv, w_uv.numpy())
        np.testing.assert_array_equal(g_c, w_c.numpy())


def test_sharded_filter_matches(port):
    import jax.numpy as jnp

    from tpuflow.dist import make_mesh
    from tpuflow.segmentation.meanshift import (
        mean_shift_filter_sharded as j_sharded,
    )
    from tpuflow_torch.segmentation import meanshift

    n, out = port
    lab = _inputs()["ms_lab"]
    single = meanshift.mean_shift_filter(torch.from_numpy(lab), *MS)
    want = j_sharded(jnp.asarray(lab), make_mesh(n), *MS)
    for g, s, w in zip(out["ms"], single, want):
        np.testing.assert_array_equal(g, s.numpy())
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-12)
