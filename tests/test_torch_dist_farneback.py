"""tpuflow_torch.dist.farneback_sharded on gloo CPU meshes, against the
port's single-device solver and tpuflow's sharded solver, in float64.

The meshes, 1x2 and 2x2 CPU ranks, come from one spawn of four gloo
ranks (a module fixture: the 2x2 mesh of all four, then the 1x2 sub-mesh
of ranks 0 and 1) and run every case there. The tiles compute the
single-device sums in the same order, so the port's sharded flow equals
``calc_optical_flow_farneback(..., use_blur_kernel=True)`` bitwise; and it
is held to tpuflow's ``farneback_sharded`` on its 8-device CPU mesh (2x4)
within atol 1e-9 x max(1, max|u|) (the two sum the taps in other orders,
and tpuflow's default warp is its dense-shift sweep: the Farneback
parity bound of tests/test_torch_farneback.py is 1e-8 against it).
Cases: levels 1 (even winsize 16, odd 15), 2 and 3 at 64x128, |flow|
about (2, 1) px; the clamp halo against an edge pad; the ValueErrors.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from tpuflow_torch import dist as D
from tpuflow_torch.dist import make_mesh, run_on_mesh
from tpuflow_torch.dist.mesh import Mesh
from tpuflow_torch.solvers import calc_optical_flow_farneback

H, W = 64, 128
MESHES = (2, 4)
ATOL_TPUFLOW = 1e-9
CASES = {
    "levels1_even16": (0.5, 1, 16, 2, 5, 1.2),
    "levels1_odd15": (0.5, 1, 15, 3, 5, 1.1),
    "levels2": (0.5, 2, 15, 3, 5, 1.2),
    "levels3": (0.5, 3, 15, 3, 5, 1.2),
}


def _pair():
    rng = np.random.default_rng(31)
    base = gaussian_filter(rng.uniform(0, 255, (H + 8, W + 8)), 3.0)
    return base[:H, :W].copy(), base[1:1 + H, 2:2 + W].copy()


def _suite(mesh):
    """Every case on the 2x2 mesh of the four ranks, then on the 1x2
    sub-mesh of ranks 0 and 1 (every rank creates it; ranks 2 and 3 get
    None and wait)."""
    out = {mesh.size: _cases(mesh)}
    sub = make_mesh(2, device="cpu")
    if sub is not None:
        out[sub.size] = _cases(sub)
    return out


def _cases(mesh):
    prev, nxt = (torch.from_numpy(a) for a in _pair())
    out = {key: [t.numpy() for t in D.farneback_sharded(prev, nxt, mesh,
                                                        *cfg)]
           for key, cfg in CASES.items()}
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(3, H, W)))
    th, tw = H // mesh.ty, W // mesh.tx
    tile = x[:, mesh.iy * th:(mesh.iy + 1) * th,
             mesh.ix * tw:(mesh.ix + 1) * tw]
    out["halo"] = D.gather_tiles(
        D.halo_pad_2d_clamp(tile.contiguous(), 5, mesh)[
            :, 5:-5, 5:-5].contiguous(), mesh).numpy()
    out["halo_tile"] = D.halo_pad_2d_clamp(tile.contiguous(), 5,
                                           mesh).numpy()
    out["origin"] = (mesh.iy * th, mesh.ix * tw)
    return out


@pytest.fixture(scope="module")
def meshes():
    return run_on_mesh(_suite, 4, "gloo", "cpu", timeout=300)


@pytest.fixture(scope="module", params=MESHES, ids=lambda n: f"mesh{n}")
def port(request, meshes):
    return request.param, meshes[request.param]


@pytest.fixture(scope="module")
def single():
    prev, nxt = (torch.from_numpy(a) for a in _pair())
    return {key: [t.numpy() for t in calc_optical_flow_farneback(
        prev, nxt, None, *cfg, use_blur_kernel=True)]
        for key, cfg in CASES.items()}


_JAX = {}


def _tpuflow(key):
    if key not in _JAX:
        import jax.numpy as jnp

        from tpuflow.dist import make_mesh as j_make_mesh
        from tpuflow.dist.farneback import farneback_sharded

        prev, nxt = _pair()
        _JAX[key] = [np.asarray(a) for a in farneback_sharded(
            jnp.asarray(prev), jnp.asarray(nxt), j_make_mesh(8),
            *CASES[key])]
    return _JAX[key]


@pytest.mark.parametrize("key", sorted(CASES))
def test_equals_single_device(port, single, key):
    _, out = port
    for got, want in zip(out[key], single[key]):
        assert got.shape == (H, W)
        np.testing.assert_array_equal(got, want)
    assert 1.0 < np.abs(out[key][0]).max() < 5.0


@pytest.mark.parametrize("key", sorted(CASES))
def test_matches_tpuflow(port, key):
    _, out = port
    want = _tpuflow(key)
    bound = ATOL_TPUFLOW * max(1.0, float(np.abs(want[0]).max()))
    for got, w in zip(out[key], want):
        np.testing.assert_allclose(got, w, rtol=0, atol=bound)


def test_clamp_halo_is_edge_pad(port):
    """Every rank's halo'd tile is its window of the edge-padded frame."""
    _, out = port
    x = np.random.default_rng(2).normal(size=(3, H, W))
    np.testing.assert_array_equal(out["halo"], x)
    ref = np.pad(x, ((0, 0), (5, 5), (5, 5)), mode="edge")
    r0, c0 = out["origin"]  # rank 0's tile
    th, tw = out["halo_tile"].shape[-2:]
    np.testing.assert_array_equal(out["halo_tile"],
                                  ref[:, r0:r0 + th, c0:c0 + tw])


def _mesh(ty, tx):
    return Mesh(ty, tx, 0, 0, tuple(range(ty * tx)), None,
                torch.device("cpu"), "gloo")


@pytest.mark.parametrize("shape,mesh,kw,match", [
    ((64, 128), (1, 2), dict(flags=0x100), "flags not supported"),
    ((64, 128), (1, 2), dict(flags=0x200), "flags not supported"),
    ((63, 128), (2, 2), {}, "not divisible by mesh 2x2"),
    ((16, 32), (2, 2), dict(winsize=20), "smaller than a required halo"),
    ((16, 32), (2, 2), dict(poly_n=9), "smaller than a required halo"),
])
def test_errors_match_tpuflow(shape, mesh, kw, match):
    """The ValueErrors tpuflow's farneback_sharded raises, raised before
    any exchange."""
    import jax.numpy as jnp

    from tpuflow.dist import make_mesh as j_make_mesh
    from tpuflow.dist.farneback import farneback_sharded as j_sharded

    frame = torch.zeros(shape, dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        D.farneback_sharded(frame, frame, _mesh(*mesh), **kw)
    j = jnp.zeros(shape)
    with pytest.raises(ValueError, match=match):
        j_sharded(j, j, j_make_mesh(mesh[0] * mesh[1]), **kw)
