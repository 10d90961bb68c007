"""The flagship's sharded refines (``tpuflow_torch.dist.bm_refine``:
the gated refine with and without ``mv``, one and two directions, and
the per-region affine fit) against ``tpuflow.dist``, on gloo meshes of
CPU ranks, through tests/test_torch_bm_mesh.py's :func:`_suite` (its
refine and affine parts), each mesh spawned once in this file.
Tolerance: atol 1e-10 of tpuflow.dist's fields (the same sweeps; sums of
the same terms in another order), the E(n) traces within rtol 1e-10.

jax and tpuflow are imported inside the tests only.
"""

import numpy as np
import pytest

from test_torch_bm_mesh import (  # noqa: F401
    ATOL, DEADLINE_S, MESHES, REFINE_CASES, REFINE_ITERS, _inputs, _suite)
from tpuflow_torch.dist import run_on_mesh


@pytest.fixture(scope="module", params=MESHES, ids=lambda n: f"mesh{n}")
def port(request):
    n = request.param
    return n, run_on_mesh(_suite, n, "gloo", "cpu",
                          args=(("refine", "affine"),), timeout=DEADLINE_S)


def test_ranks_agree(port):
    assert port[1]["ranks_agree"]


@pytest.mark.parametrize("key", list(REFINE_CASES))
def test_sharded_refine_matches(port, key):
    import jax.numpy as jnp

    from tpuflow.dist import bm_refine as jr
    from tpuflow.dist import make_mesh

    n, out = port
    x = _inputs()
    bidi, with_mv, sup, plateau = REFINE_CASES[key]
    j = jnp.asarray
    kw = dict(iter_max=REFINE_ITERS, sup_mode=sup, plateau_rtol=plateau)
    mvs = [j(x["mv"]), j(x["mv2"])]
    if bidi:
        pairs, trace = jr.gradient_method_flow_sharded_bidirectional(
            [j(x["refp"]), j(x["refn"])], j(x["interest"]), x["rlab"],
            make_mesh(n), mvs=mvs if with_mv else None, **kw)
        trace = np.asarray(trace)
    else:
        u, v, trace = jr.gradient_method_flow_sharded(
            j(x["refp"]), j(x["interest"]), x["rlab"], make_mesh(n),
            mv=mvs[0] if with_mv else None, **kw)
        pairs, trace = [(u, v)], np.asarray(trace)[None]
    got, got_trace = out[key]
    for (gu, gv), (wu, wv) in zip(got, pairs):
        np.testing.assert_allclose(gu, np.asarray(wu), rtol=0, atol=ATOL)
        np.testing.assert_allclose(gv, np.asarray(wv), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_trace, trace, rtol=1e-10)
    assert np.isfinite(got_trace[:, 0]).all()


@pytest.mark.parametrize("normalize", [True, False])
def test_sharded_affine_matches(port, normalize):
    import jax.numpy as jnp

    from tpuflow.dist import bm_refine as jr
    from tpuflow.dist import make_mesh

    n, out = port
    x = _inputs()
    j = jnp.asarray
    want = jr.affine_parametric_flow_sharded(
        j(x["refp"]), j(x["interest"]), j(x["mv"][..., 0]),
        j(x["mv"][..., 1]), x["rlab"], x["rn"], make_mesh(n),
        iter_max=20 if normalize else 3, normalize_steps=normalize,
        max_displacement=3)
    for g, w in zip(out[f"affine_{normalize}"], want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=ATOL)
