"""tpuflow_torch.dist.ops (the sharded L1 ops, HOG matching and scratch
detection) on gloo CPU meshes of 2 and 4 ranks, in float64.

One spawn of four ranks (a module fixture) runs every case on the 2x2
mesh and on the 1x2 sub-mesh of ranks 0 and 1. Each sharded op runs the
single-device tile body on halo'd tiles, so every result equals the
port's single-device op bitwise: ``conv2d_sharded`` and
``filterer_sharded`` (each border policy), ``gaussian_filter_sharded``
(its 2-D kernel through ``conv2d``), ``epsilon_filter_sharded``,
``horizontal_median_sharded`` (odd and even widths; the window shrinks
by GLOBAL columns), ``hog_matching_sharded`` (contiguous offset slices,
sentinel padding, in-order merge) and ``detect_scratch_sharded`` on an
integer-valued frame (its side sums add taps where the single-device
test differences prefix sums: exact on integers). The bordered halo is
each rank's window of ``bd.pad2d``. Against tpuflow's sharded ops on its
8-device CPU mesh: the median, the scratch map and HOG matching (on
tpuflow's descriptors) bitwise; the epsilon filter bitwise tpuflow's
single-device filter and within 1e-15 x 255 of its sharded one (XLA
compiles tpuflow's tile body into other bits than its single-device
filter: 2.8e-14 apart on this frame).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow_torch import dist as D
from tpuflow_torch import ops
from tpuflow_torch.core import borders as bd
from tpuflow_torch.core.config import FilterParam
from tpuflow_torch.detection import detect_scratch
from tpuflow_torch.dist import make_mesh, run_on_mesh
from tpuflow_torch.dist.ops import halo_pad_2d_border
from tpuflow_torch.features import hog

H, W = 24, 40
KERNEL = np.arange(1.0, 7.0).reshape(2, 3)
MODES = (bd.ZERO, bd.MIRROR, bd.REFLECT101, bd.CLAMP)


def _frame():
    rng = np.random.default_rng(0)
    a = np.round(rng.normal(100.0, 3.0, (H, W)))
    a[:, 9] += 40
    a[:, 21] -= 35
    a[:, 30] += 38
    return a


def _feats():
    from tpuflow.features.hog import hog_descriptor

    x = _frame() / 255.0
    _, a = hog_descriptor(jnp.asarray(x), 16, True, True)
    _, b = hog_descriptor(jnp.asarray(np.roll(x, (1, 1), (0, 1))), 16, True,
                          True)
    return np.asarray(a), np.asarray(b)


def _ops(x, feats):
    """name -> (sharded call, single-device call): the first takes the
    mesh."""
    eps = FilterParam().change_filter("e")
    eps.size = (5, 7)
    gauss = FilterParam().change_filter("g")
    gauss.size, gauss.std_deviation = (5, 5), 1.5
    calls = {
        "epsilon": (lambda m: D.epsilon_filter_sharded(x, (5, 7), 20.0, m),
                    lambda: ops.epsilon_filter(x, (5, 7), 20.0)),
        "median3": (lambda m: D.horizontal_median_sharded(x, 3, m),
                    lambda: ops.horizontal_median(x, 3)),
        "median4": (lambda m: D.horizontal_median_sharded(x, 4, m),
                    lambda: ops.horizontal_median(x, 4)),
        "gaussian": (lambda m: D.gaussian_filter_sharded(x, (5, 5), 2.0, m),
                     lambda: ops.conv2d(x, ops.gaussian_kernel(
                         (5, 5), 2.0, torch.float64))),
        "gaussian_even": (lambda m: D.gaussian_filter_sharded(
            x, (4, 6), 2.0, m), lambda: ops.gaussian_filter(x, (4, 6), 2.0)),
        "filterer_mirror": (
            lambda m: D.filterer_sharded(x, KERNEL, m, True),
            lambda: ops.filterer(x, KERNEL, True)),
        "filterer_zero": (lambda m: D.filterer_sharded(x, KERNEL, m),
                          lambda: ops.filterer(x, KERNEL)),
        "scratch": (lambda m: D.detect_scratch_sharded(x, m)[0],
                    lambda: detect_scratch(x)[0]),
        "scratch_epsilon": (
            lambda m: torch.stack(D.detect_scratch_sharded(
                x, m, 3.0, 20.0, eps)),
            lambda: torch.stack(detect_scratch(x, 3.0, 20.0, eps))),
        "scratch_gaussian_filtered": (
            lambda m: D.detect_scratch_sharded(x, m, filter_param=gauss,
                                               do_detection=False)[0],
            lambda: ops.conv2d(x, ops.gaussian_kernel((5, 5), 1.5,
                                                      torch.float64))),
    }
    for mode in MODES:
        calls[f"conv_{mode}"] = (
            lambda m, mode=mode: D.conv2d_sharded(x, KERNEL, m, mode),
            lambda mode=mode: ops.conv2d(x, KERNEL, mode))
        calls[f"conv_anchor_{mode}"] = (
            lambda m, mode=mode: D.conv2d_sharded(x, KERNEL, m, mode,
                                                  anchor=(0, 1)),
            lambda mode=mode: ops.conv2d(x, KERNEL, mode, anchor=(0, 1)))
    prv, cur = (torch.from_numpy(a) for a in feats)
    for search in ((9, 7), (33, 17)):
        calls[f"hog_{search[0]}x{search[1]}"] = (
            lambda m, s=search: torch.stack(
                D.hog_matching_sharded(prv, cur, m, *s)),
            lambda s=search: torch.stack(hog.hog_matching(prv, cur, *s)))
    return calls


def _cases(mesh, feats):
    x = torch.from_numpy(_frame())
    out = {name: fn(mesh).numpy() for name, (fn, _) in _ops(x, feats).items()}
    th, tw = H // mesh.ty, W // mesh.tx
    tile = x[mesh.iy * th:(mesh.iy + 1) * th,
             mesh.ix * tw:(mesh.ix + 1) * tw].contiguous()
    for mode in MODES:
        out[f"halo_{mode}"] = halo_pad_2d_border(tile, 3, mode, mesh, H,
                                                 W).numpy()
    out["origin"] = (mesh.iy * th, mesh.ix * tw)
    return out


def _suite(mesh, feats):
    out = {mesh.size: _cases(mesh, feats)}
    sub = make_mesh(2, device="cpu")
    if sub is not None:
        out[sub.size] = _cases(sub, feats)
    return out


@pytest.fixture(scope="module")
def meshes():
    # tpuflow's descriptors are made here, under the tests' x64 config.
    return run_on_mesh(_suite, 4, "gloo", "cpu", args=(_feats(),),
                       timeout=300)


@pytest.fixture(scope="module", params=(2, 4), ids=lambda n: f"mesh{n}")
def port(request, meshes):
    return meshes[request.param]


@pytest.fixture(scope="module")
def single():
    x = torch.from_numpy(_frame())
    return {name: ref().numpy()
            for name, (_, ref) in _ops(x, _feats()).items()}


def test_every_op_equals_single_device(port, single):
    assert sorted(k for k in port if k in single) == sorted(single)
    for name, want in single.items():
        np.testing.assert_array_equal(port[name], want, err_msg=name)
    assert (port["scratch"] == 255).sum() >= 2 * H


@pytest.mark.parametrize("mode", MODES)
def test_border_halo_is_pad2d_window(port, mode):
    x = torch.from_numpy(_frame())
    ref = bd.pad2d(x, 3, mode).numpy()
    r0, c0 = port["origin"]
    got = port[f"halo_{mode}"]
    np.testing.assert_array_equal(got, ref[r0:r0 + got.shape[0],
                                           c0:c0 + got.shape[1]])


_JAX = {}


def _tpuflow():
    if not _JAX:
        from tpuflow.dist import make_mesh as j_make_mesh
        from tpuflow.dist import ops as jops

        m = j_make_mesh(8)
        x = jnp.asarray(_frame())
        prv, cur = (jnp.asarray(a) for a in _feats())
        _JAX.update({
            "epsilon": jops.epsilon_filter_sharded(x, (5, 7), 20.0, m),
            "median3": jops.horizontal_median_sharded(x, 3, m),
            "median4": jops.horizontal_median_sharded(x, 4, m),
            "scratch": jops.detect_scratch_sharded(x, m)[0],
            "hog_9x7": jnp.stack(jops.hog_matching_sharded(prv, cur, m, 9,
                                                           7)),
        })
    return {k: np.asarray(v) for k, v in _JAX.items()}


@pytest.mark.parametrize("name", ["median3", "median4", "scratch", "hog_9x7"])
def test_matches_tpuflow_sharded(port, name):
    np.testing.assert_array_equal(port[name], _tpuflow()[name])


def test_epsilon_matches_tpuflow(port):
    from tpuflow.ops import epsilon_filter

    np.testing.assert_array_equal(port["epsilon"], np.asarray(
        epsilon_filter(jnp.asarray(_frame()), (5, 7), 20.0)))
    np.testing.assert_allclose(port["epsilon"], _tpuflow()["epsilon"],
                               rtol=0, atol=1e-15 * 255)


def test_errors():
    from tpuflow_torch.dist.mesh import Mesh

    mesh = Mesh(2, 2, 0, 0, (0, 1, 2, 3), None, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="not divisible by mesh 2x2"):
        D.epsilon_filter_sharded(torch.zeros(23, 40), (3, 3), 1.0, mesh)
    with pytest.raises(ValueError, match="odd and positive"):
        D.epsilon_filter_sharded(torch.zeros(24, 40), (4, 3), 1.0, mesh)
