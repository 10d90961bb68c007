"""Horn-Schunck at windows whose halo leaves no core in the staged tile.

On the card a window of 65 or more runs the wide form of
``csrc/hs_stencil.cu`` (per sweep, one kernel writes every cell's column
sums, a second adds them along the row and applies the update). The
kernels run only on the card, where chip_smoke.py holds them bitwise to
the plain versions. On the CPU:

- (a) the port's ``solvers.horn_schunck`` and ``hs_tile_sweeps_plain`` at
  windows 65 and 129 against tpuflow's jnp ``horn_schunck`` and its
  ``hs_tile_sweeps(..., interpret=True)``, float64, atol 1e-9 as
  tests/test_horn_schunck.py:19 (the solvers associate the update
  differently);
- (b) a test-local emulation of the wide form's order (column sums top to
  bottom from the first term, zeros beyond the frame and the tile, then W
  of them left to right from 0, outside-frame cells written as 0) equals
  ``hs_sweeps_plain`` and ``hs_tile_sweeps_plain`` bitwise in float32;
- (c) the wrappers' dispatch on a CUDA stand-in: windows of 65 or more
  take the wide form, two launches a sweep, with the geometry the
  emulation uses; smaller windows keep the staged kernel and its launch
  counts; a tile too small for its halo still raises;
- (d) the plans: every odd window runs at least one sweep per staged
  launch, or the wide form; the resident solve's groups and result buffer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.kernels.hs_stencil import hs_tile_sweeps as j_hs_tile_sweeps
from tpuflow.solvers import horn_schunck as j_horn_schunck
from tpuflow_torch.kernels import hs_stencil
from tpuflow_torch.solvers import horn_schunck

from test_torch_fb_kernels import CudaStandIn

WIDE = [65, 129]


def _frames(h, w, seed):
    """bench.py::_frames_1080p's recipe at a small size."""
    rng = np.random.default_rng(seed)
    prev = rng.uniform(0, 255, (h, w))
    return prev, np.roll(prev, 2, axis=1) + rng.normal(0, 1, (h, w))


def _hs_fields(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    u, v, gx, gy = (rng.normal(size=shape) for _ in range(4))
    gt = 0.3 * rng.normal(size=shape)
    return [torch.tensor(a, dtype=dtype)
            for a in (u, v, gx, gy, gt, 1.0 / (1.0 + gx * gx + gy * gy))]


@pytest.mark.parametrize("window", WIDE)
def test_horn_schunck_wide_matches_tpuflow(window):
    """(a) The whole solve at a wide window, 150x170, 4 iterations."""
    prev, nxt = _frames(150, 170, window)
    u, v = horn_schunck(torch.from_numpy(prev), torch.from_numpy(nxt),
                        window, 4, 1.0)
    uj, vj = j_horn_schunck(jnp.asarray(prev), jnp.asarray(nxt), window, 4,
                            1.0)
    assert float(np.abs(np.asarray(uj)).max()) > 1.0
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0, atol=1e-9)


@pytest.mark.parametrize("window,fuse", [(65, 1), (65, 2), (129, 1)])
@pytest.mark.parametrize("origin", ["corner", "interior"])
def test_hs_tile_wide_matches_tpuflow(window, fuse, origin):
    """(a) One halo'd tile of a 40x50 frame at a wide window: its core at
    the frame's corner (the halo mostly outside, holding random values the
    sweeps must ignore) or inside."""
    need = fuse * (window // 2)
    cy, cx = {"corner": (0, 0), "interior": (20, 30)}[origin]
    fields = [a.numpy() for a in _hs_fields((12 + 2 * need, 16 + 2 * need),
                                            window + fuse, torch.float64)]
    args = (cy - need, cx - need, 40, 50, window, fuse)
    u, v = hs_stencil.hs_tile_sweeps(*(torch.from_numpy(a) for a in fields),
                                     *args)
    uj, vj = j_hs_tile_sweeps(*(jnp.asarray(a) for a in fields), *args,
                              interpret=True)
    assert u.shape == (12, 16)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0, atol=1e-9)


def _wide_sweep(u, v, gx, gy, gt, inv, off, g0, fy0, fx0, img_h, img_w,
                window):
    """One sweep of the wide form (csrc/hs_block.cuh's hs_colsum_cell and
    hs_update_cell), with its arguments: (u, v) has frame origin (fy0,
    fx0), the result starts at its cell (off, off), the fixed fields are
    read from (g0, g0)."""
    r = window // 2
    in_h, in_w = u.shape
    out_h, out_w = in_h - 2 * off, in_w - 2 * off
    ys = torch.arange(in_h) + fy0
    xs = torch.arange(in_w) + fx0
    frame = (((ys >= 0) & (ys < img_h))[:, None]
             & ((xs >= 0) & (xs < img_w))[None, :])
    # Zero beyond the frame, and r rows of zeros beyond the array.
    zero_rows = torch.zeros((r, in_w), dtype=u.dtype)
    sums = []
    for f in (u, v):
        p = torch.cat([zero_rows, torch.where(frame, f, 0.0), zero_rows])
        c = p[off : off + out_h]
        for dy in range(1, window):
            c = c + p[off + dy : off + dy + out_h]
        q = torch.nn.functional.pad(c, (r, r))
        s = torch.zeros((out_h, out_w), dtype=u.dtype)
        for dx in range(window):
            s = s + q[:, off + dx : off + dx + out_w]
        sums.append(s)
    win = (slice(g0, g0 + out_h), slice(g0, g0 + out_w))
    a, b = gx[win], gy[win]
    ub = sums[0] * (1.0 / (window * window))
    vb = sums[1] * (1.0 / (window * window))
    upd = (a * ub + b * vb + gt[win]) * inv[win]
    inside = frame[off : off + out_h, off : off + out_w]
    return (torch.where(inside, ub - a * upd, 0.0),
            torch.where(inside, vb - b * upd, 0.0))


@pytest.mark.parametrize("window", [3, 5, *WIDE])
def test_wide_form_equals_hs_sweeps_plain(window):
    """(b) Whole-frame sweeps in the wide form (off 0) equal hs_sweeps_plain
    bitwise, at the wide windows and, since the form is the same at every
    window, at 3 and 5."""
    u, v, *fixed = _hs_fields((37, 53), window, torch.float32)
    want = hs_stencil.hs_sweeps_plain(u, v, *fixed, window, 3)
    for _ in range(3):
        u, v = _wide_sweep(u, v, *fixed, 0, 0, 0, 0, 37, 53, window)
    assert torch.equal(u, want[0]) and torch.equal(v, want[1])


@pytest.mark.parametrize("window,fuse", [(5, 3), (65, 1), (65, 2), (129, 2)])
@pytest.mark.parametrize("origin", ["corner", "edge", "interior"])
def test_wide_form_equals_hs_tile_sweeps_plain(window, fuse, origin):
    """(b) Tile sweeps in the wide form (sweep t: off r, the fixed fields
    read t*r in, the origin moved in by (t-1)*r) equal hs_tile_sweeps_plain
    bitwise, the tile's halo holding random values outside the frame."""
    r = window // 2
    need = fuse * r
    cy, cx = {"corner": (0, 0), "edge": (0, 20), "interior": (15, 20)}[origin]
    u_p, v_p, *fixed = _hs_fields((14 + 2 * need, 18 + 2 * need),
                                  window + 7 * fuse, torch.float32)
    row0, col0 = cy - need, cx - need
    want = hs_stencil.hs_tile_sweeps_plain(u_p, v_p, *fixed, row0, col0, 40,
                                           50, window, fuse)
    u, v = u_p, v_p
    for t in range(1, fuse + 1):
        o = (t - 1) * r
        u, v = _wide_sweep(u, v, *fixed, r, t * r, row0 + o, col0 + o, 40, 50,
                           window)
    assert u.shape == (14, 18)
    assert torch.equal(u, want[0]) and torch.equal(v, want[1])


class _Recorder:
    """Stands in for the one-launch functions: records the arguments and
    returns stand-ins of the result's shape."""

    def __init__(self):
        self.calls = []

    def wide(self, u, v, gx, gy, gt, inv, out_shape, off, g0, fy0, fx0,
             img_h, img_w, window):
        self.calls.append(("wide", tuple(u.shape), tuple(out_shape), off,
                           g0, fy0, fx0, img_h, img_w, window))
        return CudaStandIn(out_shape), CudaStandIn(out_shape)

    def sweeps(self, u, v, gx, gy, gt, inv, window, fuse):
        self.calls.append(("sweeps", window, fuse))
        return u, v

    def tile(self, u_p, v_p, gx, gy, gt, inv, row0, col0, img_h, img_w,
             window, fuse):
        self.calls.append(("tile", row0, col0, window, fuse))
        need = fuse * (window // 2)
        shape = (u_p.shape[0] - 2 * need, u_p.shape[1] - 2 * need)
        return CudaStandIn(shape), CudaStandIn(shape)


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(hs_stencil, "_wide_launch", rec.wide)
    monkeypatch.setattr(hs_stencil, "_sweeps_launch", rec.sweeps)
    monkeypatch.setattr(hs_stencil, "_tile_launch", rec.tile)
    return rec


@pytest.mark.parametrize("window", WIDE)
def test_hs_sweeps_dispatch_wide(recorder, window):
    """(c) A wide window on a CUDA tensor: fuse sweeps of the wide form,
    two launches each, off 0 on the whole frame."""
    before = hs_stencil.LAUNCHES
    fields = [CudaStandIn((30, 40)) for _ in range(6)]
    u, _ = hs_stencil.hs_sweeps(*fields, window, 3)
    assert u.shape == (30, 40)
    assert recorder.calls == [("wide", (30, 40), (30, 40), 0, 0, 0, 0, 30,
                               40, window)] * 3
    assert hs_stencil.LAUNCHES - before == 6


@pytest.mark.parametrize("window,launches", [(5, 2), (63, 16)])
def test_hs_sweeps_dispatch_staged(recorder, window, launches):
    """(c) Below 65 the staged kernel keeps its launches: ceil(fuse /
    max_fuse) (15 at window 5, 1 at window 63)."""
    fields = [CudaStandIn((30, 40)) for _ in range(6)]
    hs_stencil.hs_sweeps(*fields, window, 16)
    assert [c[0] for c in recorder.calls] == ["sweeps"] * launches
    assert sum(c[2] for c in recorder.calls) == 16


@pytest.mark.parametrize("window,fuse", [(65, 1), (65, 3), (129, 2)])
def test_hs_tile_sweeps_dispatch_wide(recorder, window, fuse):
    """(c) A wide window on a halo'd CUDA tile: sweep t takes the last
    result (r smaller each side), reads the fixed fields t*r in and moves
    the origin (t-1)*r in; two launches a sweep."""
    r = window // 2
    need = fuse * r
    before = hs_stencil.LAUNCHES_TILE
    shape = (10 + 2 * need, 12 + 2 * need)
    fields = [CudaStandIn(shape) for _ in range(6)]
    u, _ = hs_stencil.hs_tile_sweeps(*fields, 5 - need, 7 - need, 60, 70,
                                     window, fuse)
    assert u.shape == (10, 12)
    want = []
    for t in range(1, fuse + 1):
        o = (t - 1) * r
        want.append(("wide", (shape[0] - 2 * o, shape[1] - 2 * o),
                     (shape[0] - 2 * o - 2 * r, shape[1] - 2 * o - 2 * r), r,
                     t * r, 5 - need + o, 7 - need + o, 60, 70, window))
    assert recorder.calls == want
    assert hs_stencil.LAUNCHES_TILE - before == 2 * fuse


def test_hs_tile_sweeps_wide_still_refuses_no_core(recorder):
    """(c) A tile too small for its halo raises on the card, as tpuflow's
    does, at a wide window too; nothing launches."""
    fields = [CudaStandIn((128, 200)) for _ in range(6)]
    with pytest.raises(ValueError, match="no core"):
        hs_stencil.hs_tile_sweeps(*fields, 0, 0, 300, 300, 65, 2)
    assert recorder.calls == []


EDGE_WINDOWS = (1, 3, 5, 63, 65, 129, 257)


@pytest.mark.parametrize("window", EDGE_WINDOWS)
def test_every_window_has_a_plan(window):
    """(d) An odd window: the staged kernels take at least one sweep a
    launch, with a core left, or the window is 65 or more and takes the
    wide form; the resident solve fuses the same way (RESIDENT_FUSE at
    most) and its result buffer follows its group count. The ends, the
    main paths' windows and both sides of 65."""
    _window_has_a_plan(window)


def test_every_other_window_has_a_plan():
    """(d) The same for every other odd window up to 257."""
    for window in range(1, 258, 2):
        if window not in EDGE_WINDOWS:
            _window_has_a_plan(window)


def _window_has_a_plan(window):
    f_max = hs_stencil.max_fuse(window)
    if window >= 65:
        assert f_max == 0
    else:
        assert f_max >= 1
        assert min(hs_stencil.tile_for(window, min(f_max, 40))) >= 1
    for iters in (0, 1, 99, 100):
        fuse, groups = hs_stencil.resident_plan(window, iters)
        if f_max:
            assert 1 <= fuse <= min(hs_stencil.RESIDENT_FUSE, f_max)
            assert (groups - 1) * fuse < iters <= groups * fuse or iters == 0
        else:
            assert (fuse, groups) == (0, iters)
