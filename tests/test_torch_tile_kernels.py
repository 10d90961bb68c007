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
- A test-local emulation of csrc/hs_resident.cu's solve (groups of
  RESIDENT_FUSE sweeps, each tile of the frame staged with a K*r halo and
  swept as csrc/hs_block.cuh's hs_block; the wide form at window 65)
  equals the resident pair's plain versions bitwise in float32 (windows
  3, 5, 65; 7 and 8 sweeps on a 70x150 frame of 2x3 tiles), and tpuflow's
  resident kernels in interpret mode at the shapes above, atol 1e-10.
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


def _staged_sweeps(u, v, gx, gy, gt, d, y0, x0, window, k, divide):
    """csrc/hs_block.cuh's hs_block on the whole frame: the STAGE tile whose
    (0, 0) is frame cell (y0, x0), zero beyond the frame, k sweeps on a
    valid region shrinking by r a sweep (column sums top to bottom from the
    first term, then W of them from 0; cells outside the frame held at 0),
    its core (clipped to the frame) returned with its frame origin."""
    sh, sw = hs_stencil.STAGE
    h, w = u.shape
    r = window // 2
    ys, xs = torch.arange(sh) + y0, torch.arange(sw) + x0
    inside = (((ys >= 0) & (ys < h))[:, None]
              & ((xs >= 0) & (xs < w))[None, :])
    src = (slice(max(y0, 0), min(y0 + sh, h)),
           slice(max(x0, 0), min(x0 + sw, w)))
    dst = (slice(src[0].start - y0, src[0].stop - y0),
           slice(src[1].start - x0, src[1].stop - x0))

    def stage(f):
        out = torch.zeros((sh, sw), dtype=f.dtype)
        out[dst] = f[src]
        return out

    s_u, s_v, a, b, c, dd = (stage(f) for f in (u, v, gx, gy, gt, d))
    for t in range(1, k + 1):
        lo = t * r
        rows, ccols = slice(lo, sh - lo), slice(lo - r, sw - lo + r)
        sums = []
        for f in (s_u, s_v):
            cs = f[lo - r : sh - lo - r, ccols]
            for dy in range(1, window):
                cs = cs + f[lo - r + dy : sh - lo - r + dy, ccols]
            s = torch.zeros((sh - 2 * lo, sw - 2 * lo), dtype=f.dtype)
            for dx in range(window):
                s = s + cs[:, dx : dx + sw - 2 * lo]
            sums.append(s * (1.0 / (window * window)))
        core = (rows, slice(lo, sw - lo))
        ub, vb = sums
        num = a[core] * ub + b[core] * vb + c[core]
        upd = num / dd[core] if divide else num * dd[core]
        s_u, s_v = s_u.clone(), s_v.clone()
        s_u[core] = torch.where(inside[core], ub - a[core] * upd, 0.0)
        s_v[core] = torch.where(inside[core], vb - b[core] * upd, 0.0)
    need = k * r
    return (s_u[need : sh - need, need : sw - need],
            s_v[need : sh - need, need : sw - need], y0 + need, x0 + need)


def _wide_frame_sweep(u, v, gx, gy, gt, d, window, divide):
    """csrc/hs_block.cuh's wide form on the whole frame: column sums from
    the first term with zeros beyond the frame, then W of them from 0."""
    r = window // 2
    h, w = u.shape
    sums = []
    for f in (u, v):
        p = bd.pad2d(f, r, bd.ZERO)
        cs = p[0:h]
        for dy in range(1, window):
            cs = cs + p[dy : dy + h]
        s = torch.zeros_like(f)
        for dx in range(window):
            s = s + cs[:, dx : dx + w]
        sums.append(s * (1.0 / (window * window)))
    ub, vb = sums
    num = gx * ub + gy * vb + gt
    upd = num / d if divide else num * d
    return ub - gx * upd, vb - gy * upd


def _resident_emulated(prev, nxt, window, iters, alpha, divide):
    """csrc/hs_resident.cu's solve: groups of at most RESIDENT_FUSE sweeps
    (hs_stencil.resident_plan), each group every tile of the frame staged
    from the last group's (u, v), its core written to the other buffer; a
    window of 65 or more one wide-form sweep a group. resident divides by
    the denominator formed from gx, gy; resident2 multiplies by its
    reciprocal, formed once. Returns (u, v) and the groups run."""
    from tpuflow_torch.solvers.horn_schunck import hs_gradients

    gx, gy, gt = hs_gradients(prev, nxt)
    den = alpha * alpha + gx * gx + gy * gy
    d = den if divide else 1.0 / den
    u = torch.zeros_like(gt)
    v = torch.zeros_like(gt)
    fuse, _ = hs_stencil.resident_plan(window, iters)
    r = window // 2
    h, w = u.shape
    groups, done = 0, 0
    while done < iters:
        if not fuse:
            u, v = _wide_frame_sweep(u, v, gx, gy, gt, d, window, divide)
            k = 1
        else:
            k = min(fuse, iters - done)
            core_h = hs_stencil.STAGE[0] - 2 * k * r
            core_w = hs_stencil.STAGE[1] - 2 * k * r
            u_new, v_new = torch.empty_like(u), torch.empty_like(v)
            for ty in range(-(-h // core_h)):
                for tx in range(-(-w // core_w)):
                    cu, cv, oy, ox = _staged_sweeps(
                        u, v, gx, gy, gt, d, ty * core_h - k * r,
                        tx * core_w - k * r, window, k, divide)
                    ch, cw = min(core_h, h - oy), min(core_w, w - ox)
                    u_new[oy : oy + ch, ox : ox + cw] = cu[:ch, :cw]
                    v_new[oy : oy + ch, ox : ox + cw] = cv[:ch, :cw]
            u, v = u_new, v_new
        done += k
        groups += 1
    return (u, v), groups


@pytest.mark.parametrize("iters", [7, 8])
@pytest.mark.parametrize("window", [3, 5, 65])
@pytest.mark.parametrize("which", ["resident", "resident2"])
def test_resident_fused_form_equals_plain(which, window, iters):
    """The resident kernel's K-fused form (tiles staged with a K*r halo, K
    sweeps between grid syncs, 2x3 tiles of a 70x150 frame at window 5) and
    its wide form at window 65 equal horn_schunck_resident_plain /
    _resident2_plain bitwise in float32, in resident_plan's group count."""
    prev, nxt = (torch.tensor(a, dtype=torch.float32)
                 for a in _frames(70, 150, window))
    plain = {"resident": hs_stencil.horn_schunck_resident_plain,
             "resident2": hs_stencil.horn_schunck_resident2_plain}[which]
    want = plain(prev, nxt, window, iters, 1.0)
    (u, v), groups = _resident_emulated(prev, nxt, window, iters, 1.0,
                                        which == "resident")
    assert groups == hs_stencil.resident_plan(window, iters)[1]
    assert torch.equal(u, want[0]) and torch.equal(v, want[1])


@pytest.mark.parametrize("shape", [(24, 40), (40, 56)])
@pytest.mark.parametrize("which", ["resident", "resident2"])
def test_resident_fused_form_matches_tpuflow(shape, which):
    """The K-fused form against tpuflow's resident kernels in interpret
    mode, float64, atol 1e-10 as test_resident_plain_matches_tpuflow."""
    prev, nxt = _frames(*shape, seed=shape[0])
    ref = {"resident": horn_schunck_pallas_resident,
           "resident2": horn_schunck_pallas_resident2}[which]
    (u, v), _ = _resident_emulated(_t(prev), _t(nxt), 5, 9, 1.0,
                                   which == "resident")
    uj, vj = ref(jnp.asarray(prev), jnp.asarray(nxt), 5, 9, 1.0,
                 interpret=True)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0, atol=1e-10)
