"""tpuflow_torch Horn-Schunck and its fused sweep against tpuflow, on the CPU.

The port runs in float64 and takes the plain versions of its kernels (CPU
tensors); tpuflow's Pallas kernel runs in interpret mode, as
tests/test_kernels.py runs it. Tolerance atol 1e-10, as there: the
jnp solver and the fused sweep associate the update differently.
45x70 is deliberately not a multiple of any tile (the ragged edge).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.kernels import horn_schunck_pallas
from tpuflow.ops.filters import box_filter as j_box_filter
from tpuflow.solvers import horn_schunck as j_horn_schunck
from tpuflow.solvers import horn_schunck_classic as j_horn_schunck_classic
from tpuflow_torch.kernels import hs_stencil
from tpuflow_torch.solvers import horn_schunck, horn_schunck_classic

ATOL = 1e-10


def _frames(h=45, w=70, seed=0):
    """bench.py::_frames_1080p's recipe at a small size."""
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0, 255, (h, w))
    nxt = np.roll(prev, 2, axis=1) + rng.normal(0, 1, (h, w))
    return prev, nxt


def _fields(h=45, w=70, seed=11):
    rng = np.random.default_rng(seed)
    u, v, gx, gy = (rng.normal(size=(h, w)) for _ in range(4))
    gt = 0.3 * rng.normal(size=(h, w))
    inv = 1.0 / (1.0 + gx * gx + gy * gy)
    return u, v, gx, gy, gt, inv


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.mark.parametrize("iters", [1, 20])
def test_horn_schunck_matches_tpuflow(iters):
    prev, nxt = _frames()
    u, v = horn_schunck(torch.from_numpy(prev), torch.from_numpy(nxt), 5,
                        iters, 1.0)
    uj, vj = j_horn_schunck(jnp.asarray(prev), jnp.asarray(nxt), 5, iters, 1.0)
    _close(u, uj)
    _close(v, vj)


@pytest.mark.parametrize("iters,fuse", [(7, 3), (6, 3), (1, 1)])
def test_fused_matches_pallas_interpret(iters, fuse):
    """hs_sweeps_plain through horn_schunck_fused's block loop against the
    TPU kernel in interpret mode; (7, 3) takes the remainder launch."""
    prev, nxt = _frames()
    u, v = hs_stencil.horn_schunck_fused(
        torch.from_numpy(prev), torch.from_numpy(nxt), 5, iters, 1.0,
        fuse=fuse)
    uj, vj = horn_schunck_pallas(jnp.asarray(prev), jnp.asarray(nxt), 5,
                                 iters, 1.0, tile_h=32, tile_w=128,
                                 fuse=fuse, interpret=True)
    _close(u, uj)
    _close(v, vj)


@pytest.mark.parametrize("window", [3, 5])
def test_sweeps_plain_matches_jnp_sweeps(window):
    """From nonzero (u, v) on the ragged 45x70 frame: hs_sweeps_plain
    against sweeps built from tpuflow's box_filter."""
    u, v, gx, gy, gt, inv = _fields()
    ut, vt = hs_stencil.hs_sweeps_plain(
        *(torch.from_numpy(a) for a in (u, v, gx, gy, gt, inv)),
        window=window, fuse=4)
    uj, vj = jnp.asarray(u), jnp.asarray(v)
    for _ in range(4):
        ub = j_box_filter(uj, window)
        vb = j_box_filter(vj, window)
        upd = (gx * ub + gy * vb + gt) * inv
        uj, vj = ub - gx * upd, vb - gy * upd
    _close(ut, uj, atol=1e-12)
    _close(vt, vj, atol=1e-12)


def test_iterate_blocks_equal_one_plain_run():
    """Blocks of 3 plus a remainder of 1 are exactly 7 plain sweeps."""
    fields = [torch.from_numpy(a) for a in _fields()]
    before = hs_stencil.LAUNCHES
    u1, v1 = hs_stencil.hs_iterate(*fields, window=5, n_iters=7, fuse=3)
    u2, v2 = hs_stencil.hs_sweeps_plain(*fields, window=5, fuse=7)
    assert torch.equal(u1, u2) and torch.equal(v1, v2)
    assert hs_stencil.LAUNCHES == before  # CPU tensors launch nothing


def test_horn_schunck_classic_matches_tpuflow():
    prev, nxt = _frames(24, 31)
    u, v = horn_schunck_classic(torch.from_numpy(prev), torch.from_numpy(nxt),
                                15, 1.0)
    uj, vj = j_horn_schunck_classic(jnp.asarray(prev), jnp.asarray(nxt),
                                    15, 1.0)
    _close(u, uj)
    _close(v, vj)


def test_sweeps_reject_bad_fields():
    fields = [torch.from_numpy(a) for a in _fields()]
    with pytest.raises(ValueError):
        hs_stencil.hs_sweeps(fields[0][:, :-1], *fields[1:])
    with pytest.raises(ValueError):
        hs_stencil.hs_sweeps(*fields, window=4)
    with pytest.raises(ValueError):
        hs_stencil.hs_sweeps(*(f.to("meta") for f in fields))


def test_smem_budget_of_default_fuse():
    """The default fuse fits one block's shared memory on Hopper."""
    from tpuflow_torch.kernels._build import MAX_SMEM_BYTES

    assert hs_stencil.smem_bytes(5, hs_stencil.DEFAULT_FUSE) <= MAX_SMEM_BYTES
