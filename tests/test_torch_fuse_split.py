"""Deep fuses as several launches (``kernels._build.split_fuse``), on the CPU.

On a CUDA tensor a block of sweeps deeper than one launch takes (F_max,
set by the staged tile) runs as ceil(F / F_max) launches: whole-frame
sweeps hand (u, v) on, a tile sweep hands its core on with the origin moved
in and the fixed fields cut to the same window. The kernels run only on the
card, where chip_smoke.py holds each deep block bitwise to its plain
version. Here each wrapper's own split helper (``_split_sweeps``,
``_split_tile``, ``_split_gated``, which the wrapper calls with its one-launch
function) runs the kernel's plain version as its per-launch body, with
F_max cut to 3:

- float32, bitwise (``torch.equal``) one plain call of the full fuse, for
  all five split wrappers (hs_sweeps, hs_tile_sweeps, irls_sweeps,
  irls_tile_sweeps, irls_gated_sweeps), fuses 1 to 3 * F_max + 1, tiles at
  the frame's corner, edge and interior, with ceil(F / F_max) calls;
- float64, the IRLS pair against tpuflow's Pallas kernels in interpret mode
  at a fuse deeper than the real F_max, with tpuflow's sup (a contraction,
  as the solvers run it), atol 1e-11 as tests/test_torch_black_anandan.py:95.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuflow.solvers.black_anandan as jba
from tpuflow.kernels import irls_sweep_pallas
from tpuflow.kernels.irls_stencil import irls_tile_sweeps as j_irls_tile_sweeps
from tpuflow_torch.kernels import hs_stencil, irls_stencil
from tpuflow_torch.kernels._build import fuse_parts

F_MAX = 3
FUSES = range(1, 3 * F_MAX + 2)
IMG = (21, 29)
CORE = (7, 11)
# Core origins in the frame: at the top-left corner, on the bottom edge,
# inside.
ORIGINS = {"corner": (0, 0), "edge": (14, 9), "interior": (6, 8)}
IRLS_CONSTS = (5.0, 1.0, 0.3, 0.1)  # lambda_d, lambda_s, sigma_d, sigma_s
# tests/test_torch_black_anandan.py's constants, for the tpuflow cases.
BA_CONSTS = (5.0, 1.0, 0.4, 0.2)


def _f32(rng, shape, scale=1.0):
    return torch.tensor(scale * rng.normal(size=shape), dtype=torch.float32)


def counting(fn):
    """fn, counting its calls in ``.calls``."""
    def wrapped(*args):
        wrapped.calls += 1
        return fn(*args)
    wrapped.calls = 0
    return wrapped


def _check(got, want, body, fuse):
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
    assert body.calls == -(-fuse // F_MAX)


@pytest.mark.parametrize("fuse", [1, 2, 15, 16, 17, 40, 100])
@pytest.mark.parametrize("f_max", [1, 3, 15, 35])
def test_fuse_parts(fuse, f_max):
    parts = fuse_parts(fuse, f_max)
    assert sum(parts) == fuse and len(parts) == -(-fuse // f_max)
    assert max(parts) <= f_max and max(parts) - min(parts) <= 1
    assert parts == sorted(parts, reverse=True)


def test_fuse_parts_rejects_no_room():
    with pytest.raises(ValueError, match="no sweep fits"):
        fuse_parts(4, 0)


@pytest.mark.parametrize("fuse", FUSES)
def test_hs_sweeps_split(fuse):
    rng = np.random.default_rng(fuse)
    u, v, gx, gy, gt = (_f32(rng, IMG) for _ in range(5))
    inv = 1.0 / (1.0 + gx * gx + gy * gy)
    body = counting(hs_stencil.hs_sweeps_plain)
    got = hs_stencil._split_sweeps(body, u, v, gx, gy, gt, inv, 5, fuse,
                                   f_max=F_MAX)
    _check(got, hs_stencil.hs_sweeps_plain(u, v, gx, gy, gt, inv, 5, fuse),
           body, fuse)


@pytest.mark.parametrize("origin", ORIGINS)
@pytest.mark.parametrize("fuse", FUSES)
@pytest.mark.parametrize("window", [3, 5])
def test_hs_tile_sweeps_split(window, fuse, origin):
    """The intermediate cores reach outside the frame at the corner and
    edge origins; the plain version zeroes them as the kernel does."""
    r = window // 2
    need = fuse * r
    rng = np.random.default_rng(10 * fuse + window)
    shape = (CORE[0] + 2 * need, CORE[1] + 2 * need)
    u, v, gx, gy, gt = (_f32(rng, shape) for _ in range(5))
    inv = 1.0 / (1.0 + gx * gx + gy * gy)
    cy, cx = ORIGINS[origin]
    row0, col0 = cy - need, cx - need
    body = counting(hs_stencil.hs_tile_sweeps_plain)
    got = hs_stencil._split_tile(body, u, v, gx, gy, gt, inv, row0, col0,
                                 *IMG, window, fuse, f_max=F_MAX)
    want = hs_stencil.hs_tile_sweeps_plain(u, v, gx, gy, gt, inv, row0, col0,
                                           *IMG, window, fuse)
    assert want[0].shape == CORE
    _check(got, want, body, fuse)


def _irls(rng, shape):
    u, v = _f32(rng, shape, 0.2), _f32(rng, shape, 0.2)
    gx, gy = _f32(rng, shape), _f32(rng, shape)
    return u, v, gx, gy, _f32(rng, shape, 0.1)


SUPS = (torch.tensor([40.0]), torch.tensor([45.0]))


@pytest.mark.parametrize("fuse", FUSES)
def test_irls_sweeps_split(fuse):
    u, v, gx, gy, it = _irls(np.random.default_rng(fuse), IMG)
    body = counting(irls_stencil.irls_sweeps_plain)
    got = irls_stencil._split_sweeps(body, u, v, gx, gy, it, *SUPS, fuse,
                                     *IRLS_CONSTS, f_max=F_MAX)
    _check(got, irls_stencil.irls_sweeps_plain(u, v, gx, gy, it, *SUPS, fuse,
                                               *IRLS_CONSTS), body, fuse)


@pytest.mark.parametrize("origin", ORIGINS)
@pytest.mark.parametrize("fuse", FUSES)
def test_irls_tile_sweeps_split(fuse, origin):
    """Intermediate cores reach outside the frame at the corner and edge
    origins: their cells are never read by a cell in the frame."""
    rng = np.random.default_rng(20 + fuse)
    fields = _irls(rng, (CORE[0] + 2 * fuse, CORE[1] + 2 * fuse))
    cy, cx = ORIGINS[origin]
    row0, col0 = cy - fuse, cx - fuse
    body = counting(irls_stencil.irls_tile_sweeps_plain)
    got = irls_stencil._split_tile(body, *fields, *SUPS, row0, col0, *IMG,
                                   fuse, *IRLS_CONSTS, f_max=F_MAX)
    want = irls_stencil.irls_tile_sweeps_plain(*fields, *SUPS, row0, col0,
                                               *IMG, fuse, *IRLS_CONSTS)
    assert want[0].shape == CORE
    _check(got, want, body, fuse)


@pytest.mark.parametrize("fuse", FUSES)
def test_irls_gated_sweeps_split(fuse):
    """Two reference directions, labels of 3x4 blocks."""
    rng = np.random.default_rng(30 + fuse)
    u, v, it = (_f32(rng, (2, *IMG), 0.2) for _ in range(3))
    gx, gy = _f32(rng, IMG), _f32(rng, IMG)
    ids = rng.integers(0, 4, (IMG[0] // 3 + 1, IMG[1] // 4 + 1))
    labels = torch.from_numpy(np.repeat(np.repeat(ids, 3, 0), 4, 1)
                              [:IMG[0], :IMG[1]].astype(np.int32))
    body = counting(irls_stencil.irls_gated_sweeps_plain)
    got = irls_stencil._split_gated(body, u, v, gx, gy, it, labels, *SUPS,
                                    fuse, *IRLS_CONSTS, f_max=F_MAX)
    _check(got, irls_stencil.irls_gated_sweeps_plain(
        u, v, gx, gy, it, labels, *SUPS, fuse, *IRLS_CONSTS), body, fuse)


def _t64(*arrays):
    return [torch.tensor(np.asarray(a), dtype=torch.float64) for a in arrays]


def test_irls_sweeps_split_matches_tpuflow():
    """A block deeper than the kernel's F_max, split as the wrapper splits
    it on the card, against tpuflow's kernel in interpret mode."""
    fuse = irls_stencil.MAX_FUSE + 5
    rng = np.random.default_rng(5)
    shape = (19, 26)
    u, v = 0.2 * rng.normal(size=shape), 0.2 * rng.normal(size=shape)
    gx, gy, it = (rng.normal(size=shape) for _ in range(3))
    sup = jba.irls_sup(jnp.asarray(gx), jnp.asarray(gy), *BA_CONSTS)
    uj, vj = irls_sweep_pallas(*map(jnp.asarray, (u, v, gx, gy, it)), *sup,
                               fuse, *BA_CONSTS, fuse=fuse, interpret=True)
    ut, vt, *fixed = _t64(u, v, gx, gy, it)
    sups = _t64(*sup)
    body = counting(irls_stencil.irls_sweeps_plain)
    got = irls_stencil._split_sweeps(body, ut, vt, *fixed, *sups, fuse,
                                     *BA_CONSTS)
    assert body.calls == 2
    for a, b in zip(got, (uj, vj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-11)


def test_irls_tile_sweeps_split_matches_tpuflow():
    """A tile at the frame's corner, a block deeper than F_max."""
    fuse = irls_stencil.MAX_FUSE + 5
    rng = np.random.default_rng(6)
    img = (50, 60)
    shape = (CORE[0] + 2 * fuse, CORE[1] + 2 * fuse)
    u, v = 0.2 * rng.normal(size=shape), 0.2 * rng.normal(size=shape)
    gx, gy, it = (rng.normal(size=shape) for _ in range(3))
    row0, col0 = img[0] - CORE[0] - fuse, img[1] - CORE[1] - fuse
    sup = [float(s) for s in jba.irls_sup(jnp.asarray(gx), jnp.asarray(gy),
                                          *BA_CONSTS)]
    uj, vj = j_irls_tile_sweeps(*map(jnp.asarray, (u, v, gx, gy, it)), *sup,
                                row0, col0, *img, fuse, *BA_CONSTS,
                                interpret=True)
    ut, vt, *fixed = _t64(u, v, gx, gy, it)
    sups = _t64([sup[0]], [sup[1]])
    body = counting(irls_stencil.irls_tile_sweeps_plain)
    got = irls_stencil._split_tile(body, ut, vt, *fixed, *sups, row0, col0,
                                   *img, fuse, *BA_CONSTS)
    assert body.calls == 2 and got[0].shape == CORE
    for a, b in zip(got, (uj, vj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-11)
