"""The tile-sweep and resident HS kernels' plain versions against tpuflow.

On the CPU the wrappers take the plain versions (the CUDA kernels are held
bitwise to them on the card by chip_smoke.py). tpuflow's Pallas kernels
run in interpret mode, as tests/test_kernels.py runs them; float64.

- hs_tile_sweeps / irls_tile_sweeps on random halo'd tiles whose core sits
  inside, at an edge and at a corner of the frame (the halo's cells
  outside the frame hold random values, which the sweeps must ignore),
  fuse 1-4, windows 3 and 5: atol 1e-12 (the same operations in another
  association order at most).
- A 2x2 cut of a frame, swept tile by tile and stitched, equals the
  whole-frame sweeps bitwise.
- The resident pair on seeded 24x40 and 40x56 frames, 9 iterations, atol
  1e-10 as tests/test_kernels.py:223 (the jnp solver and the kernels
  associate the update differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.kernels.hs_stencil import (
    horn_schunck_pallas_resident,
    horn_schunck_pallas_resident2,
)
from tpuflow.kernels.hs_stencil import hs_tile_sweeps as j_hs_tile_sweeps
from tpuflow.kernels.irls_stencil import irls_tile_sweeps as j_irls_tile_sweeps
from tpuflow_torch.core import borders as bd
from tpuflow_torch.kernels import hs_stencil, irls_stencil
from tpuflow_torch.kernels._build import MAX_SMEM_BYTES

IMG = (20, 28)
CORE = (8, 12)
# Core origins in the frame: inside, on the top edge, at the bottom-right
# corner.
ORIGINS = {"interior": (6, 8), "edge": (0, 8), "corner": (12, 16)}
IRLS_CONSTS = (5.0, 1.0, 0.3, 0.1)  # lambda_d, lambda_s, sigma_d, sigma_s


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _halod(need):
    """The CORE with a ``need`` halo on each side."""
    return CORE[0] + 2 * need, CORE[1] + 2 * need


def _hs_fields(shape, seed):
    rng = np.random.default_rng(seed)
    u, v, gx, gy = (rng.normal(size=shape) for _ in range(4))
    gt = 0.3 * rng.normal(size=shape)
    return u, v, gx, gy, gt, 1.0 / (1.0 + gx * gx + gy * gy)


@pytest.mark.parametrize("origin", ORIGINS)
@pytest.mark.parametrize("fuse", [1, 2, 3, 4])
@pytest.mark.parametrize("window", [3, 5])
def test_hs_tile_plain_matches_tpuflow(origin, fuse, window):
    need = fuse * (window // 2)
    fields = _hs_fields(_halod(need), 100 * fuse + window)
    cy, cx = ORIGINS[origin]
    row0, col0 = cy - need, cx - need
    u, v = hs_stencil.hs_tile_sweeps(*(_t(a) for a in fields), row0, col0,
                                     *IMG, window, fuse)
    uj, vj = j_hs_tile_sweeps(*(jnp.asarray(a) for a in fields), row0, col0,
                              *IMG, window, fuse, interpret=True)
    assert u.shape == CORE
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0, atol=1e-12)


def _irls_fields(shape, seed):
    rng = np.random.default_rng(seed)
    u, v = 0.2 * rng.normal(size=shape), 0.2 * rng.normal(size=shape)
    gx, gy = rng.normal(size=shape), rng.normal(size=shape)
    return u, v, gx, gy, 0.1 * rng.normal(size=shape)


@pytest.mark.parametrize("origin", ORIGINS)
@pytest.mark.parametrize("fuse", [1, 2, 3, 4])
def test_irls_tile_plain_matches_tpuflow(origin, fuse):
    fields = _irls_fields(_halod(fuse), 7 * fuse)
    cy, cx = ORIGINS[origin]
    row0, col0 = cy - fuse, cx - fuse
    sup_x, sup_y = 40.0, 45.0
    u, v = irls_stencil.irls_tile_sweeps(
        *(_t(a) for a in fields), _t(sup_x), _t(sup_y), row0, col0, *IMG,
        fuse, *IRLS_CONSTS)
    uj, vj = j_irls_tile_sweeps(*(jnp.asarray(a) for a in fields), sup_x,
                                sup_y, row0, col0, *IMG, fuse, *IRLS_CONSTS,
                                interpret=True)
    assert u.shape == CORE
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0, atol=1e-12)


def _cut_2x2(fields, need):
    """Each quarter of a frame with a ``need`` halo of the zero-padded
    frame, with its frame origin."""
    h, w = fields[0].shape
    th, tw = h // 2, w // 2
    padded = [bd.pad2d(f, need, bd.ZERO) for f in fields]
    for i in range(2):
        for k in range(2):
            yield (i, k), [p[i * th : i * th + th + 2 * need,
                             k * tw : k * tw + tw + 2 * need].contiguous()
                           for p in padded], (i * th - need, k * tw - need)


def _stitch(tiles):
    return torch.cat([torch.cat([tiles[i, 0], tiles[i, 1]], dim=1)
                      for i in range(2)], dim=0)


@pytest.mark.parametrize("window,fuse", [(3, 1), (5, 3), (5, 4)])
def test_hs_tiles_stitch_to_whole_frame(window, fuse):
    fields = [_t(a) for a in _hs_fields(IMG, 5)]
    need = fuse * (window // 2)
    us, vs = {}, {}
    for key, tile, (row0, col0) in _cut_2x2(fields, need):
        us[key], vs[key] = hs_stencil.hs_tile_sweeps(*tile, row0, col0,
                                                     *IMG, window, fuse)
    u, v = hs_stencil.hs_sweeps_plain(*fields, window, fuse)
    assert torch.equal(_stitch(us), u) and torch.equal(_stitch(vs), v)


@pytest.mark.parametrize("fuse", [1, 4])
def test_irls_tiles_stitch_to_whole_frame(fuse):
    fields = [_t(a) for a in _irls_fields(IMG, 9)]
    sups = (_t(40.0), _t(45.0))
    us, vs = {}, {}
    for key, tile, (row0, col0) in _cut_2x2(fields, fuse):
        us[key], vs[key] = irls_stencil.irls_tile_sweeps(
            *tile, *sups, row0, col0, *IMG, fuse, *IRLS_CONSTS)
    u, v = irls_stencil.irls_sweeps_plain(*fields, *sups, fuse, *IRLS_CONSTS)
    assert torch.equal(_stitch(us), u) and torch.equal(_stitch(vs), v)


def _frames(h, w, seed):
    """bench.py::_frames_1080p's recipe at a small size."""
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0, 255, (h, w))
    return prev, np.roll(prev, 2, axis=1) + rng.normal(0, 1, (h, w))


@pytest.mark.parametrize("shape", [(24, 40), (40, 56)])
@pytest.mark.parametrize("which", ["resident", "resident2"])
def test_resident_plain_matches_tpuflow(shape, which):
    prev, nxt = _frames(*shape, seed=shape[0])
    port = {"resident": hs_stencil.horn_schunck_resident,
            "resident2": hs_stencil.horn_schunck_resident2}[which]
    ref = {"resident": horn_schunck_pallas_resident,
           "resident2": horn_schunck_pallas_resident2}[which]
    before = (hs_stencil.LAUNCHES_RESIDENT, hs_stencil.LAUNCHES_RESIDENT2)
    u, v = port(_t(prev), _t(nxt), 5, 9, 1.0)
    uj, vj = ref(jnp.asarray(prev), jnp.asarray(nxt), 5, 9, 1.0,
                 interpret=True)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
    # CPU tensors take the plain version and launch nothing.
    assert (hs_stencil.LAUNCHES_RESIDENT,
            hs_stencil.LAUNCHES_RESIDENT2) == before


def test_resident2_plain_is_the_fused_solve():
    """resident2 computes horn_schunck_fused's inverse and sweeps."""
    prev, nxt = (_t(a) for a in _frames(24, 40, 1))
    u, v = hs_stencil.horn_schunck_resident2_plain(prev, nxt, 5, 11, 1.0)
    uf, vf = hs_stencil.horn_schunck_fused(prev, nxt, 5, 11, 1.0)
    assert torch.equal(u, uf) and torch.equal(v, vf)


def test_tile_wrappers_reject_bad_calls():
    hs = [_t(a) for a in _hs_fields(_halod(2), 1)]
    with pytest.raises(ValueError, match="no core"):
        hs_stencil.hs_tile_sweeps(*hs, 0, 0, *IMG, 5, 3)
    with pytest.raises(ValueError, match="odd window"):
        hs_stencil.hs_tile_sweeps(*hs, 0, 0, *IMG, 4, 1)
    ir = [_t(a) for a in _irls_fields(_halod(2), 1)]
    sups = (_t(1.0), _t(1.0))
    with pytest.raises(ValueError, match="leaves"):
        irls_stencil.irls_tile_sweeps(*ir, *sups, -3, 0, *IMG, 2)
    with pytest.raises(ValueError, match="one-element"):
        irls_stencil.irls_tile_sweeps(*ir, _t([1.0, 2.0]), sups[1], 0, 0,
                                      *IMG, 2)


@pytest.mark.parametrize("window,fuse", [(5, 5), (5, 10), (3, 16)])
def test_tile_kernel_block_fits_shared_memory(window, fuse):
    """Deep fuses (the weak-scaling row's 10) still leave a core in the
    staged tile, whose shared memory fits one block."""
    core = hs_stencil.tile_for(window, fuse)
    need = fuse * (window // 2)
    assert core == (hs_stencil.STAGE[0] - 2 * need,
                    hs_stencil.STAGE[1] - 2 * need)
    assert min(core) >= 1
    assert hs_stencil.smem_bytes(window, fuse) <= MAX_SMEM_BYTES
    assert irls_stencil.smem_bytes(16) <= MAX_SMEM_BYTES
