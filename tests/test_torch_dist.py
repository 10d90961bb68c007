"""tpuflow_torch.dist against tpuflow.dist, on gloo meshes of CPU ranks.

Each mesh shape (1x1, 1x2, 2x2, 2x4) is spawned once, through
``run_on_mesh``, in a module-scoped fixture: every rank runs every case
of :func:`_suite` in float64 and rank 0 returns numpy results. The same
seeded inputs go through tpuflow.dist on ``make_mesh(n)`` of the 8-device
virtual CPU mesh (tests/conftest.py), in this process. Tolerances: halos
exactly; the solvers atol 1e-10 (both sum the same sweeps, in other
association orders); the pyramid atol 5e-8, as tests/test_dist.py holds
tpuflow's own sharded pyramid.

jax and tpuflow are imported inside the tests only: the spawned ranks
import this module to find :func:`_suite`.
"""

import numpy as np
import pytest
import torch

from tpuflow_torch.dist import mesh_factor, run_on_mesh

MESHES = (1, 2, 4, 8)
ATOL = 1e-10
# tpuflow's Black-Anandan constants (tpuflow/solvers/black_anandan.py).
LAMBDA_D, LAMBDA_S = 5.0, 1.0
# The launcher's deadline for one mesh's whole suite, in seconds.
DEADLINE_S = 300.0


def _inputs() -> dict:
    """Seeded inputs, drawn as tests/test_dist.py draws its own."""
    rng = np.random.default_rng(3)
    x = {"halo_x": rng.normal(size=(16, 32)),
         "hs_prev": rng.uniform(0, 255, size=(32, 64)),
         "hs_next": rng.uniform(0, 255, size=(32, 64))}
    for key, shape in (("irls", (16, 32)), ("irls0", (16, 16)),
                       ("irls_an", (16, 16))):
        x[key] = (rng.normal(size=shape), rng.normal(size=shape),
                  0.1 * rng.normal(size=shape))
    r = np.random.default_rng(4)
    x["fused_prev"] = r.uniform(0, 255, (48, 96))
    x["fused_next"] = np.roll(x["fused_prev"], 1, axis=1)
    r = np.random.default_rng(5)
    x["rem_prev"] = r.uniform(0, 255, (48, 96))
    x["rem_next"] = r.uniform(0, 255, (48, 96))
    r = np.random.default_rng(10)
    x["irls_f"] = (r.normal(size=(32, 64)), r.normal(size=(32, 64)),
                   0.1 * r.normal(size=(32, 64)))
    x["pyr_prev"], x["pyr_next"] = _smooth_pair((64, 80), 11)
    return x


def _smooth_pair(shape, seed):
    """bench.py::_frames_kitti's recipe at a small size: smoothed noise and
    the same scene moved by (4, 2) px."""
    from scipy.ndimage import gaussian_filter

    h, w = shape
    rng = np.random.default_rng(seed)
    base = gaussian_filter(rng.uniform(0, 255, (h + 8, w + 8)), 2.0)
    return base[:h, :w].copy(), base[4 : 4 + h, 2 : 2 + w].copy()


IRLS_CASES = {  # key -> (inputs, sigma_d, sigma_s, iters, level0, sup_mode)
    "irls": ("irls", 0.4, 0.2, 30, False, "reference"),
    "irls_level0": ("irls0", 0.14, 0.02, 70, True, "reference"),
    "irls_analytic": ("irls_an", 0.14, 0.02, 70, True, "analytic"),
}
FUSED_CASES = {  # key -> (iters, level0, fuse)
    "irls_fused": (24, False, 4),
    "irls_fused_level0": (70, True, 4),
}
PYR_FUSE = (4, 0)


def _errors(mesh, t) -> dict:
    """The ValueErrors of the port on this mesh, by case."""
    from tpuflow_torch import dist as D

    z = t(np.zeros((30, 63)))
    big = t(np.zeros((16, 32)))
    calls = {
        "indivisible": lambda: D.horn_schunck_sharded(z, z, mesh),
        "fused_halo": lambda: D.horn_schunck_sharded_fused(
            big, big, mesh, 5, 10, 1.0, fuse=4),
        "dynamic_multiple": lambda: D.horn_schunck_sharded_fused_dynamic(
            big, big, mesh, 5, 7, 1.0, fuse=2),
        "irls_fused_halo": lambda: D.irls_level_sharded_fused(
            big, big, big, big, big, mesh, LAMBDA_D, LAMBDA_S, 0.4, 0.2, 8,
            1e-6, False, fuse=8),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _suite(mesh) -> dict:
    """Every case on this rank's mesh; numpy results (rank 0's are kept)."""
    from tpuflow_torch import dist as D
    from tpuflow_torch.core.config import MultipleMotionParam

    x = _inputs()

    def t(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float64))

    def n(pair):
        return [p.numpy() for p in pair]

    out = {"shape": mesh.shape}
    xt = D.tile_of(t(x["halo_x"]), mesh)
    out["halo"] = D.gather_tiles(D.halo_pad_2d(xt, 2, mesh), mesh).numpy()
    out["shift_tx"] = D.gather_tiles(D.shift_along(xt, mesh, "tx", 1),
                                     mesh).numpy()
    out["shift_ty"] = D.gather_tiles(D.shift_along(xt, mesh, "ty", -1),
                                     mesh).numpy()
    prev, nxt = t(x["hs_prev"]), t(x["hs_next"])
    out["hs"] = n(D.horn_schunck_sharded(prev, nxt, mesh, 5, 10))
    fprev, fnext = t(x["fused_prev"]), t(x["fused_next"])
    out["hs_fused"] = n(D.horn_schunck_sharded_fused(fprev, fnext, mesh, 5, 12,
                                                     1.0, fuse=4))
    out["hs_fused_unfused"] = n(D.horn_schunck_sharded(fprev, fnext, mesh, 5,
                                                       12))
    out["hs_fused_rem"] = n(D.horn_schunck_sharded_fused(
        t(x["rem_prev"]), t(x["rem_next"]), mesh, 5, 7, 1.0, fuse=3))
    out["hs_dynamic"] = n(D.horn_schunck_sharded_fused_dynamic(
        fprev, fnext, mesh, 5, 12, 1.0, fuse=4))
    for key, (src, sd, ss, iters, level0, sup) in IRLS_CASES.items():
        gx, gy, it = (t(a) for a in x[src])
        z = torch.zeros_like(gx)
        out[key] = n(D.irls_level_sharded(z, z, gx, gy, it, mesh, LAMBDA_D,
                                          LAMBDA_S, sd, ss, iters, 1e-6,
                                          level0, sup_mode=sup))
    gx, gy, it = (t(a) for a in x["irls_f"])
    z = torch.zeros_like(gx)
    for key, (iters, level0, fuse) in FUSED_CASES.items():
        out[key] = n(D.irls_level_sharded_fused(
            z, z, gx, gy, it, mesh, LAMBDA_D, LAMBDA_S, 0.4, 0.2, iters,
            1e-6, level0, fuse=fuse))
    param = MultipleMotionParam(level=2)
    for fuse in PYR_FUSE:
        sweeps = []
        out[f"pyramid_fuse{fuse}"] = n(D.optical_flow_pyramid_sharded(
            t(x["pyr_prev"]), t(x["pyr_next"]), mesh, 255.0, param,
            iter_scale=0.02, fuse=fuse, sweeps=sweeps))
        out[f"pyramid_fuse{fuse}_sweeps"] = sweeps
    out["weak"] = D.weak_scaling_report(tile_hw=(32, 32), iterations=4,
                                        fuse=2, repeats=1, device="cpu")
    out["errors"] = _errors(mesh, t)
    return out


@pytest.fixture(scope="module", params=MESHES, ids=lambda n: f"mesh{n}")
def port(request):
    n = request.param
    return n, run_on_mesh(_suite, n, "gloo", "cpu", timeout=DEADLINE_S)


_JAX_CACHE = {}


def _tpu(n: int, key: str):
    """tpuflow.dist's result for case ``key`` on make_mesh(n), cached."""
    if (n, key) in _JAX_CACHE:
        return _JAX_CACHE[n, key]
    import jax.numpy as jnp

    from tpuflow.core.config import MultipleMotionParam
    from tpuflow.dist import make_mesh
    from tpuflow.dist import solvers as S
    from tpuflow.dist.pyramid import optical_flow_pyramid_sharded

    mesh = make_mesh(n)
    x = _inputs()
    j = jnp.asarray
    if key == "hs":
        r = S.horn_schunck_sharded(j(x["hs_prev"]), j(x["hs_next"]), mesh, 5,
                                   10)
    elif key == "hs_fused":
        r = S.horn_schunck_sharded_fused(j(x["fused_prev"]),
                                         j(x["fused_next"]), mesh, 5, 12, 1.0,
                                         fuse=4)
    elif key == "hs_fused_unfused":
        r = S.horn_schunck_sharded(j(x["fused_prev"]), j(x["fused_next"]),
                                   mesh, 5, 12)
    elif key == "hs_fused_rem":
        r = S.horn_schunck_sharded_fused(j(x["rem_prev"]), j(x["rem_next"]),
                                         mesh, 5, 7, 1.0, fuse=3)
    elif key == "hs_dynamic":
        r = S.horn_schunck_sharded_fused_dynamic(
            j(x["fused_prev"]), j(x["fused_next"]), mesh, 5, 12, 1.0, fuse=4)
    elif key in IRLS_CASES:
        src, sd, ss, iters, level0, sup = IRLS_CASES[key]
        gx, gy, it = (j(a) for a in x[src])
        z = jnp.zeros_like(gx)
        r = S.irls_level_sharded(z, z, gx, gy, it, mesh, LAMBDA_D, LAMBDA_S,
                                 sd, ss, iters, 1e-6, level0, sup_mode=sup)
    elif key in FUSED_CASES:
        iters, level0, fuse = FUSED_CASES[key]
        gx, gy, it = (j(a) for a in x["irls_f"])
        z = jnp.zeros_like(gx)
        r = S.irls_level_sharded_fused(z, z, gx, gy, it, mesh, LAMBDA_D,
                                       LAMBDA_S, 0.4, 0.2, iters, 1e-6,
                                       level0, fuse=fuse)
    else:
        fuse = int(key.removeprefix("pyramid_fuse"))
        r = optical_flow_pyramid_sharded(
            j(x["pyr_prev"]), j(x["pyr_next"]), mesh, 255.0,
            MultipleMotionParam(level=2), iter_scale=0.02, fuse=fuse)
    _JAX_CACHE[n, key] = [np.asarray(a) for a in r]
    return _JAX_CACHE[n, key]


def _close(got, want, atol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 7, 8, 16])
def test_mesh_factor_matches_tpuflow(n):
    from tpuflow.dist import mesh_factor as j_mesh_factor

    assert mesh_factor(n) == j_mesh_factor(n)


def test_mesh_shape_matches_tpuflow(port):
    from tpuflow.dist import make_mesh

    n, out = port
    assert tuple(out["shape"]) == make_mesh(n).devices.shape


def test_halo_pad_matches_global_zero_pad(port):
    """Every padded tile == its window of the globally zero-padded frame."""
    n, out = port
    ty, tx = mesh_factor(n)
    x = _inputs()["halo_x"]
    h, w, r = 16, 32, 2
    th, tw = h // ty, w // tx
    gp = np.pad(x, r)
    for i in range(ty):
        for k in range(tx):
            tile = out["halo"][i * (th + 2 * r) : (i + 1) * (th + 2 * r),
                               k * (tw + 2 * r) : (k + 1) * (tw + 2 * r)]
            np.testing.assert_array_equal(
                tile, gp[i * th : i * th + th + 2 * r,
                         k * tw : k * tw + tw + 2 * r])


def test_shift_along_moves_tiles_and_zero_fills(port):
    n, out = port
    ty, tx = mesh_factor(n)
    x = _inputs()["halo_x"]
    th, tw = 16 // ty, 32 // tx
    want_tx = np.zeros_like(x)
    want_tx[:, tw:] = x[:, :-tw]  # +1 along tx: from the left neighbour
    want_ty = np.zeros_like(x)
    want_ty[:-th, :] = x[th:, :]  # -1 along ty: from the lower neighbour
    np.testing.assert_array_equal(out["shift_tx"], want_tx)
    np.testing.assert_array_equal(out["shift_ty"], want_ty)


@pytest.mark.parametrize("key", ["hs", "hs_fused", "hs_fused_unfused",
                                 "hs_fused_rem", "hs_dynamic"])
def test_horn_schunck_sharded_matches_tpuflow(port, key):
    n, out = port
    _close(out[key], _tpu(n, key), ATOL)


@pytest.mark.parametrize("key", [*IRLS_CASES, *FUSED_CASES])
def test_irls_level_sharded_matches_tpuflow(port, key):
    n, out = port
    _close(out[key], _tpu(n, key), ATOL)


@pytest.mark.parametrize("fuse", PYR_FUSE)
def test_pyramid_sharded_matches_tpuflow(port, fuse):
    n, out = port
    _close(out[f"pyramid_fuse{fuse}"], _tpu(n, f"pyramid_fuse{fuse}"), 5e-8)
    assert len(out[f"pyramid_fuse{fuse}_sweeps"]) == 3


def test_fused_hs_equals_single_device_port(port):
    """The fused sharded HS runs the single-device sweeps cell for cell."""
    from tpuflow_torch.solvers import horn_schunck

    n, out = port
    x = _inputs()
    u, v = horn_schunck(torch.from_numpy(x["fused_prev"]),
                        torch.from_numpy(x["fused_next"]), 5, 12, 1.0)
    np.testing.assert_array_equal(out["hs_fused"][0], u.numpy())
    np.testing.assert_array_equal(out["hs_fused"][1], v.numpy())


def test_weak_scaling_report_structure(port):
    from tpuflow.dist.scaling import weak_scaling_report as j_report

    n, out = port
    rep = out["weak"]
    want = j_report(tile_hw=(32, 32), iterations=4, fuse=2, repeats=1)
    assert rep["tile"] == want["tile"] and rep["iterations"] == 4
    assert len(rep["runs"]) == n.bit_length()
    assert rep["runs"][0]["devices"] == 1
    assert rep["runs"][0]["efficiency"] == 1.0
    for got, ref in zip(rep["runs"], want["runs"]):
        assert set(got) == set(ref)
        assert (got["devices"], got["mesh"], got["image"]) == \
            (ref["devices"], ref["mesh"], ref["image"])
        assert got["seconds"] > 0 and got["mpix_per_s"] > 0


def test_value_errors_match_tpuflow(port):
    import jax.numpy as jnp

    from tpuflow.dist import make_mesh
    from tpuflow.dist import solvers as S

    n, out = port
    mesh = make_mesh(n)
    z = jnp.zeros((30, 63))
    big = jnp.zeros((16, 32))
    calls = {
        "indivisible": lambda: S.horn_schunck_sharded(z, z, mesh),
        "fused_halo": lambda: S.horn_schunck_sharded_fused(
            big, big, mesh, 5, 10, 1.0, fuse=4),
        "dynamic_multiple": lambda: S.horn_schunck_sharded_fused_dynamic(
            big, big, mesh, 5, 7, 1.0, fuse=2),
        "irls_fused_halo": lambda: S.irls_level_sharded_fused(
            big, big, big, big, big, mesh, LAMBDA_D, LAMBDA_S, 0.4, 0.2, 8,
            1e-6, False, fuse=8),
    }
    for name, call in calls.items():
        try:
            call()
            want = None
        except ValueError as e:
            want = str(e)
        assert out["errors"][name] == want, name
