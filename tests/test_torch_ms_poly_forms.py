"""The arithmetic forms of the redesigned mean-shift and poly-expansion
kernels, on the CPU.

The kernels run only on the card, where chip_smoke.py holds them bitwise
to their plain versions. These tests check, in float32 and bitwise (bit
patterns, so a sign of zero counts), that the orders the kernels compute
are the plain versions' arithmetic:

- (a) the mean-shift traversal of ``csrc/ms_filter.cu``: per row dy, the
  run of dx from the sqrt estimate, moved by the exact float32 spatial
  test until tight and clipped to [-E, E], is exactly the set of offsets
  that pass the spatial test (brute force over the full square), for
  thousands of drifts; the rows outside the kernel's row range have none;
- (b) a test-local emulation of the whole kernel (the runs, the colour
  test alone inside them, the colour sums in offset order, dx, dy and the
  count summed in int through the packed per-row sum, and each query
  stopped at the first iteration that gives its state back bit for bit)
  equals ``mean_shift_filter_plain``;
- (c) a test-local emulation of ``csrc/fb_kernels.cu``'s register-blocked
  poly expansion (blocks of POLY_TILE_H x POLY_TILE_W outputs, POLY_ACC
  accumulators a thread fed a streamed column, then streamed rows, the
  G^-1 rows summed from -0 over the kept coefficients) equals
  ``fb_poly_expansion_plain`` at the compiled tap counts and a run-time one;
- (d) the Python-side geometry matches the CUDA sources: tiles, threads,
  compiled tap counts, shared memory, and the tile rows the mean-shift
  launcher picks;
- (e) past the old ceilings: the mean-shift filter's wide form (nothing
  staged; dx, dy and the count summed in float in offset order) equals
  the plain version past the staged form's window; sepconv's and the poly
  expansion's register-blocked orders equal theirs at tap counts past the
  parameter structs (the taps from device memory); the wrappers pick
  each form by shape. The two-launch wide forms of sepconv, poly and
  blur-solve compute each output with the plain version's loops, one
  thread an output, so the plain version is their model;
- (f) a test-local emulation of the redesigned blur-solve (blocks of
  TILE_H x TILE_W outputs; each channel's columns streamed past
  BLUR_ROWS_ACC accumulators, then its rows past BLUR_ACC, adds only, from
  the first term on; the five scaled sums solved per pixel) equals
  ``fb_blur_solve_plain``.
"""

import math
import re

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from tpuflow_torch.kernels import fb_kernels, ms_filter, sepconv
from tpuflow_torch.kernels._build import MAX_SMEM_BYTES
from tpuflow_torch.segmentation.meanshift import _color_sentinel
from tpuflow_torch.solvers.farneback import _poly_exp_matrices

from test_torch_sweep_forms import (CSRC, SMEM_PER_SM,
                                    SMEM_RESERVED_PER_BLOCK, _cu_constants,
                                    _sepconv_blocked, _sliding_taps)

F32 = torch.float32


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


# -- (a), (b) the mean-shift traversal ----------------------------------------


def _in_disc(dx, ex, ty2, hs2):
    """The spatial test of offset dx, as the plain version computes it."""
    tx = dx.to(F32) - ex
    return tx * tx + ty2 <= hs2


def _row_run(ex, ty2, hs2, E):
    """csrc/ms_filter.cu's run of a row, over vectors of queries: the ends
    from sqrtf(hs2 - ty2), each moved by the exact test until tight, then
    clipped to [-E, E] (lo > hi: none). ty2 <= hs2 for every query."""
    half = torch.sqrt(hs2 - ty2)
    lo = torch.ceil(ex - half).long()
    hi = torch.floor(ex + half).long()
    for move in ((lambda: _in_disc(lo - 1, ex, ty2, hs2), -1, "lo"),
                 (lambda: (lo <= hi) & ~_in_disc(lo, ex, ty2, hs2), 1, "lo"),
                 (lambda: _in_disc(hi + 1, ex, ty2, hs2), 1, "hi"),
                 (lambda: (hi >= lo) & ~_in_disc(hi, ex, ty2, hs2), -1,
                  "hi")):
        test, step, end = move
        while (m := test()).any():
            if end == "lo":
                lo = lo + step * m
            else:
                hi = hi + step * m
    return lo.clamp_min(-E), hi.clamp_max(E)


def _row_range(ey, reach, E):
    """The kernel's rows: within reach of floor/ceil of ey, clipped."""
    return ((torch.floor(ey).long() - reach).clamp_min(-E),
            (torch.ceil(ey).long() + reach).clamp_max(E))


def _drifts(R, E, seed):
    """Drift components: integers and half-integers across [-E, E], the
    values at +-R and one float32 step either side, random values, and
    drifts past the square (as after an empty window's jump)."""
    f = np.float32
    vals = [np.arange(-E, E + 1, dtype=f), np.arange(-E, E, dtype=f) + f(0.5)]
    for v in (f(R), f(-R), f(R) / 2, f(0.0)):
        vals.append(np.array([np.nextafter(v, f(-np.inf)), v,
                              np.nextafter(v, f(np.inf))], dtype=f))
    rng = np.random.default_rng(seed)
    vals.append(rng.uniform(-E, E, 40).astype(f))
    vals.append(np.array([E + R, -E - R, -E - R - 0.5, -500.0], dtype=f))
    return torch.from_numpy(np.unique(np.concatenate(vals)))


@pytest.mark.parametrize("R,margin", [(20, None), (5, None), (7, 2)])
def test_row_runs_equal_brute_force(R, margin):
    """(a) For every drift (ex, ey) of _drifts x _drifts and every row of
    the square, the kernel's run is exactly the offsets that pass the
    spatial test; rows outside its row range (and rows with ty2 > hs2)
    have none."""
    E = ms_filter.window(R, margin)
    hs2 = float(R) ** 2
    d = _drifts(R, E, R)
    ex = d.repeat_interleave(len(d))
    ey = d.repeat(len(d))
    y_lo, y_hi = _row_range(ey, math.ceil(R), E)
    dxs = torch.arange(-E, E + 1)
    for dy in range(-E, E + 1):
        ty = float(dy) - ey
        ty2 = ty * ty
        brute = _in_disc(dxs[None, :], ex[:, None], ty2[:, None], hs2)
        live = (y_lo <= dy) & (dy <= y_hi) & (ty2 <= hs2)
        assert not brute[~live].any()
        lo, hi = _row_run(ex[live], ty2[live], hs2, E)
        run = (dxs[None, :] >= lo[:, None]) & (dxs[None, :] <= hi[:, None])
        assert torch.equal(run, brute[live])


def _ms_emulated(lab, R, ki, iters, margin, wide=False):
    """csrc/ms_filter.cu on every query at once: rows of the kernel's row
    range, the run of each row, the colour test alone inside it, the
    colour sums in offset order (a failed test adds nothing), the count
    and sum of dx + E of a row packed into one int, dy summed in int (the
    wide form: dx, dy and 1 added in float, point by point in offset
    order); a query whose iteration gives its state (drift, colour) back
    bit for bit stops. Returns (pos, col) and the iterations each query
    ran."""
    h, w = lab.shape[:2]
    E = ms_filter.window(R, margin)
    hs2 = float(R) ** 2
    hr2 = float(ki) ** 2
    reach = math.ceil(R)
    shift = 16
    key = (1 << shift) + E
    padded = _color_sentinel(lab, ki).expand(h + 2 * E, w + 2 * E,
                                             3).clone()
    padded[E : E + h, E : E + w] = lab
    flat = padded.reshape(-1, 3)
    ys, xs = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(h), torch.arange(w), indexing="ij"))
    c = [lab.reshape(-1, 3)[:, i] for i in range(3)]
    ex = torch.zeros(h * w, dtype=F32)
    ey = torch.zeros_like(ex)
    ran = torch.zeros(h * w, dtype=torch.long)
    live_q = torch.ones(h * w, dtype=torch.bool)
    for _ in range(iters):
        s = [torch.zeros_like(ex) for _ in range(3)]
        s_n = torch.zeros(h * w, dtype=F32 if wide else torch.long)
        s_dx, s_dy = s_n.clone(), s_n.clone()
        y_lo, y_hi = _row_range(ey, reach, E)
        for j in range(2 * reach + 2):
            dy = y_lo + j
            ty = dy.to(F32) - ey
            ty2 = ty * ty
            live = (dy <= y_hi) & (ty2 <= hs2)
            lo, hi = _row_run(ex, torch.where(live, ty2, hs2), hs2, E)
            n_pts = torch.where(live, hi - lo + 1, 0).clamp_min(0)
            packed = torch.zeros_like(s_n)
            base = (ys + E + dy) * (w + 2 * E) + xs + E
            for k in range(int(n_pts.max())):
                ok = k < n_pts
                q = flat[torch.where(ok, base + lo + k, 0)]
                a, b, cc = (q[:, i] - c[i] for i in range(3))
                ok &= a * a + b * b + cc * cc <= hr2
                s = [torch.where(ok, s[i] + q[:, i], s[i]) for i in range(3)]
                packed += torch.where(ok, key + lo + k, 0)
                if wide:
                    s_dx = torch.where(ok, s_dx + (lo + k).to(F32), s_dx)
                    s_dy = torch.where(ok, s_dy + dy.to(F32), s_dy)
                    s_n = torch.where(ok, s_n + 1.0, s_n)
            if not wide:
                count = packed >> shift
                s_n += count
                s_dx += (packed & ((1 << shift) - 1)) - E * count
                s_dy += dy * count
        nn = torch.clamp_min(s_n.to(F32), 1.0)
        got = s_n > 0
        new = [torch.where(got, s_dx.to(F32) / nn, -xs.to(F32)),
               torch.where(got, s_dy.to(F32) / nn, -ys.to(F32)),
               *(si / nn for si in s)]
        old = [ex, ey, *c]
        fixed = torch.stack([_bits(a) == _bits(b)
                             for a, b in zip(new, old)]).all(0)
        ex, ey, *c = (torch.where(live_q, a, b) for a, b in zip(new, old))
        ran += live_q
        live_q &= ~fixed
    pos = torch.stack([xs.to(F32) + ex, ys.to(F32) + ey], -1)
    return (pos.reshape(h, w, 2), torch.stack(c, -1).reshape(h, w, 3)), ran


def _banded_lab(h, w, seed):
    """Three colour bands with smooth noise: the colour test splits them,
    the drifts go fractional, and the square reaches past the frame."""
    rng = np.random.default_rng(seed)
    base = np.array([[0.2, 0.5, 0.4], [0.35, 0.45, 0.6], [0.7, 0.3, 0.5]])
    band = np.minimum(3 * np.arange(w) // w, 2)
    lab = base[band][None].repeat(h, 0)
    lab = lab + gaussian_filter(rng.normal(0, 0.2, (h, w, 3)), (1.5, 1.5, 0))
    return torch.tensor(lab, dtype=F32)


def test_ms_emulation_equals_plain():
    """(b) The kernel's traversal, sums and fixed-point stop equal
    mean_shift_filter_plain bitwise on a 24x40 frame: R = 5 (E = 10) at 2
    and at 6 iterations, where some queries stop early and some run all,
    and R = 20 with margin 4 (E = 24, a disc taller than the frame) at 2."""
    lab = _banded_lab(24, 40, 3)
    for R, ki, iters, margin in ((5, 0.08, 2, None), (5, 0.08, 6, None),
                                 (20, 0.06, 2, 4)):
        want = ms_filter.mean_shift_filter_plain(lab, R, ki, iters, margin)
        got, ran = _ms_emulated(lab, R, ki, iters, margin)
        _assert_bitwise(got, want)
        # The case is not trivial: drifts are fractional and colours mix.
        assert (want[0] != torch.round(want[0])).any()
        if iters == 6:
            assert (ran < iters).any() and (ran == iters).any()


# -- (c) the poly expansion's register-blocked order --------------------------


def _stream(taps_sets, n, load, acc_n):
    """csrc/fb_kernels.cu's poly_stream: one bank of acc_n accumulators
    per tap set, fed one stream; each bank sums exactly as sepconv's
    sliding_taps does (the banks never mix)."""
    return [_sliding_taps(taps, n, load, acc_n) for taps in taps_sets]


def _poly_blocked(padded, g, gx, gxx, ginv):
    """csrc/fb_kernels.cu's poly expansion on every block of the grid at
    once: blocks of POLY_TILE_H x POLY_TILE_W outputs; the vertical passes
    on the block's POLY_TILE_W + n - 1 columns in row groups of POLY_ACC
    (inputs past the padded image read as 0), three tap sets per stream;
    the horizontal passes along each row in column groups of POLY_ACC,
    rg into (m00, m10, m20), rgx into (m01, m11), rgxx into m02; then each
    G^-1 row summed from -0 over its nonzero coefficients (none: 0)."""
    th, tw = fb_kernels.POLY_TILE_H, fb_kernels.POLY_TILE_W
    r = fb_kernels.POLY_ACC
    hp, wp = padded.shape
    n = len(g)
    ho, wo = hp - n + 1, wp - n + 1
    nby, nbx = -(-ho // th), -(-wo // tw)
    ncols = tw + n - 1
    p = torch.zeros((nby * th + n - 1, nbx * tw + n - 1), dtype=F32)
    p[:hp, :wp] = padded
    # (row group, block column, input q, column c): the vertical passes.
    cols = p.unfold(0, r + n - 1, r).unfold(1, ncols, tw)
    acc = _stream((g, gx, gxx), n, lambda q: cols[:, :, q, :], r)
    rg, rgx, rgxx = (torch.stack(a, 1).reshape(nby * th, nbx, ncols)
                     for a in acc)

    def horizontal(src, sets):
        # (row, block column, column group, input q).
        segs = src.unfold(2, r + n - 1, r)
        assert segs.shape[2] == tw // r
        return [torch.stack(a, -1).reshape(nby * th, nbx * tw)
                for a in _stream(sets, n, lambda q: segs[..., q], r)]

    m00, m10, m20 = horizontal(rg, (g, gx, gxx))
    m01, m11 = horizontal(rgx, (g, gx))
    m02, = horizontal(rgxx, (g,))
    m = (m00, m10, m01, m20, m02, m11)
    outs = []
    for row in ginv:
        acc = torch.full_like(m00, -0.0)
        for coef, mq in zip(row, m):
            if coef != 0.0:
                acc = acc + mq * float(coef)
        if not np.any(row != 0.0):
            acc = torch.zeros_like(m00)
        outs.append(acc[:ho, :wo])
    return tuple(outs)


def _poly_inputs(n, out_hw, seed):
    """A 0-255 image with an exact-zero block (signed-zero products) and
    the taps rounded once to float32, as the wrapper rounds them."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(-255, 255, (out_hw[0] + 2 * n, out_hw[1] + 2 * n))
    img[3 : 3 + 2 * n + 4, 5 : 5 + 2 * n + 9] = 0.0
    g, ginv = _poly_exp_matrices(n, 0.15 * n + 0.4)
    xs = np.arange(-n, n + 1, dtype=np.float64)
    rows = ginv[1:6].copy()
    rows[4] *= 0.5
    taps = [sepconv.host_taps(t, F32) for t in (g, g * xs, g * xs * xs)]
    return torch.tensor(img, dtype=F32), taps, sepconv.host_taps(rows, F32)


def test_poly_register_blocked_equals_plain():
    """(c) The redesigned order equals fb_poly_expansion_plain bitwise at
    the compiled tap counts (11, 17), a run-time count (7) and the largest
    (64), on ragged sizes of one and several blocks; and with G^-1 rows
    that keep no coefficient, start at a zero coefficient, or hold -0."""
    for n, out_hw in ((5, (37, 150)), (8, (20, 131)), (3, (17, 300)),
                      (8, (5, 9)), (31, (18, 140))):
        img, taps, rows = _poly_inputs(n, out_hw, n)
        odd = rows.reshape(5, 6).copy()
        odd[0] = 0.0
        odd[1, :2] = (0.0, -0.0)
        odd[2, 3] = -0.0
        odd[3] = (-0.5, 0.0, 0.0, 0.0, 0.0, 0.0)
        for ginv in (rows.reshape(5, 6), odd):
            want = fb_kernels.fb_poly_expansion_plain(img, *taps, ginv)
            _assert_bitwise(_poly_blocked(img, *taps, ginv), want)
        # Over the zero block, the row that keeps only -0.5 gives -0.
        if out_hw[0] > 5:
            a22 = want[3]
            assert bool((torch.signbit(a22) & (a22 == 0)).any())


# -- (d) geometry against the sources -----------------------------------------


def _blocks_by_smem(smem: int) -> int:
    return SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK)


def test_ms_geometry_matches_cuda_source():
    """(d) The wrapper's tile, window bound and point size are
    csrc/ms_filter.cu's, and the packed row sum is exact up to MAX_E."""
    c = _cu_constants("ms_filter")
    assert (c["TW"], c["MIN_TH"], c["MAX_TH"], c["MAX_E"]) == (
        ms_filter.TILE_W, 1, ms_filter.TILE_H, ms_filter.MAX_E)
    assert c["BYTES"] == ms_filter.POINT_BYTES
    assert "using Layout = Interleaved;" in (CSRC / "ms_filter.cu").read_text()
    E, shift = ms_filter.MAX_E, c["COUNT_SHIFT"]
    assert (2 * E + 1) * 2 * E < 1 << shift
    assert (2 * E + 1) << shift < 1 << 31
    assert (2 * E + 1) ** 2 * E < 1 << 24  # int sums are exact in float32
    for E in (10, 24, 40):
        for th in (1, 7, ms_filter.TILE_H):
            pitch = (ms_filter.TILE_W + 2 * E) | 1
            assert ms_filter.smem_bytes(E, th) == 16 * (th + 2 * E) * pitch


def test_ms_tile_rows():
    """(d) Up to the flagship's E = 40 and beyond (E <= 46), a block takes
    the full 24 query rows, one block per SM at E = 40; wider windows take
    fewer rows, down to one at E = 52 (R = 26 with the default margin); a
    window whose one row does not fit runs the wide form, 24 rows a
    block."""
    for E in range(0, 47):
        assert ms_filter.tile_rows(E) == ms_filter.TILE_H
    assert _blocks_by_smem(ms_filter.smem_bytes(40, ms_filter.TILE_H)) == 1
    rows = [ms_filter.tile_rows(E) for E in range(47, 53)]
    assert rows == sorted(rows, reverse=True) and rows[-1] >= 1
    for E in range(0, 53):
        th = ms_filter.tile_rows(E)
        assert ms_filter.smem_bytes(E, th) <= MAX_SMEM_BYTES
        assert th == ms_filter.TILE_H or \
            ms_filter.smem_bytes(E, th + 1) > MAX_SMEM_BYTES
    assert ms_filter.form_for(53) == "wide"
    assert ms_filter.tile_rows(53) == ms_filter.TILE_H


def test_poly_geometry_matches_cuda_source():
    """(d) The wrapper's poly tile, threads and accumulators are the
    source's; one horizontal item a thread; every tap count up to
    MAX_POLY_TAPS fits with at least two blocks per SM."""
    c = _cu_constants("fb_kernels")
    assert (c["PH"], c["PW"], c["PR"], c["P_THREADS"]) == (
        fb_kernels.POLY_TILE_H, fb_kernels.POLY_TILE_W, fb_kernels.POLY_ACC,
        fb_kernels.POLY_THREADS)
    assert (fb_kernels.POLY_TILE_H * fb_kernels.POLY_TILE_W
            // fb_kernels.POLY_ACC == fb_kernels.POLY_THREADS)
    for taps in range(1, fb_kernels.MAX_POLY_TAPS + 1):
        smem = fb_kernels.poly_smem_bytes(taps)
        assert smem <= MAX_SMEM_BYTES and _blocks_by_smem(smem) >= 2


def test_poly_compiled_counts_match_cuda_source():
    """(d) The tap counts compiled in are poly_kernel_for's cases; every
    other count takes the run-time instantiation."""
    src = (CSRC / "fb_kernels.cu").read_text()
    body = src[src.index("PolyFn poly_kernel_for("):]
    body = body[:body.index("\n}\n")]
    cases = re.findall(r"case (\d+): return fb_poly_expansion_kernel<(\d+)>;",
                       body)
    assert all(a == b for a, b in cases)
    assert tuple(int(a) for a, _ in cases) == fb_kernels.POLY_COMPILED_TAPS
    assert "return fb_poly_expansion_kernel<0>;" in body
    for n in fb_kernels.POLY_COMPILED_TAPS:
        assert fb_kernels.poly_instantiation(n) == n
    for n in (1, 7, 9, 13, 15, 33, 64):
        assert fb_kernels.poly_instantiation(n) == 0


# -- (e) the wide forms -------------------------------------------------------


@pytest.mark.parametrize("R,ki,iters,margin", [(4, 0.08, 2, 49),
                                               (3, 0.1, 2, 125)])
def test_ms_wide_emulation_equals_plain(R, ki, iters, margin):
    """(e) The wide form's traversal and float sums equal
    mean_shift_filter_plain bitwise past the staged form's window: E = 53
    (the first the staged tile cannot hold) and E = 128 (past the packed
    row sums' 127), on a 12x20 frame whose window reaches far past it."""
    E = ms_filter.window(R, margin)
    assert ms_filter.form_for(E) == "wide"
    lab = _banded_lab(12, 20, E)
    want = ms_filter.mean_shift_filter_plain(lab, R, ki, iters, margin)
    got, _ = _ms_emulated(lab, R, ki, iters, margin, wide=True)
    _assert_bitwise(got, want)
    assert (want[0] != torch.round(want[0])).any()


def test_ms_forms_by_window():
    """(e) The staged form up to E = 52 (the flagship's E = 40 among them,
    24 query rows), the wide form from 53 on, past MAX_E too."""
    assert ms_filter.form_for(ms_filter.window(20, None)) == "staged"
    assert ms_filter.tile_rows(40) == ms_filter.TILE_H
    for E in range(0, 53):
        assert ms_filter.form_for(E) == "staged"
    for E in (53, 60, ms_filter.MAX_E, ms_filter.MAX_E + 1, 300):
        assert ms_filter.form_for(E) == "wide"
        assert ms_filter.tile_rows(E) == ms_filter.TILE_H


@pytest.mark.parametrize("taps", [(161, 3), (40, 170), (129, 129)])
def test_sepconv_blocked_past_parameter_struct_equals_plain(taps):
    """(e) sepconv's register-blocked order with more taps than the
    parameter struct holds (the DEVICE_TAPS instantiation) equals
    sep_conv2d_valid_plain bitwise."""
    nky, nkx = taps
    assert sepconv.instantiation(nky, nkx) == (sepconv.DEVICE_TAPS,) * 2
    rng = np.random.default_rng(nky + 7 * nkx)
    padded = torch.tensor(rng.uniform(-255, 255, (69 + nky, 140 + nkx)),
                          dtype=F32)
    ky = sepconv.host_taps(rng.normal(size=nky), F32)
    kx = sepconv.host_taps(rng.uniform(0.1, 1.0, nkx), F32)
    assert torch.equal(_sepconv_blocked(padded, ky, kx),
                       sepconv.sep_conv2d_valid_plain(padded, ky, kx))


def test_poly_blocked_past_parameter_struct_equals_plain():
    """(e) The poly expansion's register-blocked order at 67 taps (n = 33,
    the DEVICE_TAPS instantiation) equals fb_poly_expansion_plain
    bitwise."""
    n = 33
    assert fb_kernels.poly_instantiation(2 * n + 1) == fb_kernels.DEVICE_TAPS
    img, taps, rows = _poly_inputs(n, (18, 140), n)
    ginv = rows.reshape(5, 6)
    _assert_bitwise(_poly_blocked(img, *taps, ginv),
                    fb_kernels.fb_poly_expansion_plain(img, *taps, ginv))


def test_forms_by_tap_count_and_winsize():
    """(e) The main paths' tap counts and winsizes take the staged kernels;
    each wide form starts where a block's tile no longer fits: sepconv at
    653 kx taps (any ky count), poly at 997 taps, blur-solve at winsize
    599."""
    for n in (3, 9, 15, 17, 48, 64, 128, 129, 652):
        assert sepconv.form_for(n, n) == "staged"
    assert sepconv.form_for(5000, 5) == "staged"
    assert sepconv.form_for(5, 653) == sepconv.form_for(653, 653) == "wide"
    for n in (11, 17, 7, 65, 995):
        assert fb_kernels.poly_form(n) == "staged"
    assert fb_kernels.poly_form(997) == "wide"
    for w in (15, 48, 64, 200, 598):
        assert fb_kernels.blur_form(w) == "staged"
    assert fb_kernels.blur_form(599) == "wide"
    for w, f in ((598, "staged"), (599, "wide")):
        assert (fb_kernels.blur_smem_bytes(w) <= MAX_SMEM_BYTES) == \
            (f == "staged")


# -- (f) the blur-solve's order -----------------------------------------------


def _box_stream(n, load, acc_n):
    """csrc/fb_kernels.cu's box_stream: sepconv's streamed order with unit
    taps (x * 1 is x, exactly), so adds only."""
    return _sliding_taps(np.ones(n, np.float32), n, load, acc_n)


def _blur_inv_area(winsize):
    return float(sepconv.host_taps([1.0 / (winsize * winsize)], F32)[0])


def _blur_blocked(mp, winsize):
    """csrc/fb_kernels.cu's blur-solve on every block of the grid at once:
    blocks of TILE_H x TILE_W outputs; each channel's vertical sums on the
    block's TILE_W + winsize - 1 columns, BLUR_ROWS_ACC rows a stream
    (inputs past the padded field read as 0); then each row's horizontal
    sums in groups of BLUR_ACC; the five sums scaled and solved."""
    th, tw = fb_kernels.TILE_H, fb_kernels.TILE_W
    rv, rh = fb_kernels.BLUR_ROWS_ACC, fb_kernels.BLUR_ACC
    _, hp, wp = mp.shape
    ho, wo = hp - winsize + 1, wp - winsize + 1
    nby, nbx = -(-ho // th), -(-wo // tw)
    ncols = tw + winsize - 1
    p = torch.zeros((5, nby * th + winsize - 1, nbx * tw + winsize - 1),
                    dtype=F32)
    p[:, :hp, :wp] = mp
    # (channel, row group, block column, input q, column c).
    cols = p.unfold(1, rv + winsize - 1, rv).unfold(2, ncols, tw)
    acc = _box_stream(winsize, lambda q: cols[..., q, :], rv)
    rows = torch.stack(acc, 2).reshape(5, nby * rv, nbx, ncols)
    # (channel, row, block column, column group, input q).
    segs = rows.unfold(3, rh + winsize - 1, rh)
    assert segs.shape[3] == tw // rh
    acc = _box_stream(winsize, lambda q: segs[..., q], rh)
    box = torch.stack(acc, -1).reshape(5, nby * rv, nbx * tw)
    blurred = box[:, :ho, :wo] * _blur_inv_area(winsize)
    return fb_kernels.solve_2x2(*blurred)


@pytest.mark.parametrize("winsize", [1, 2, 3, 15, 48, 64, 200])
@pytest.mark.parametrize("out_hw", [(17, 131), (34, 260)])
def test_blur_register_blocked_equals_plain(winsize, out_hw):
    """(f) The redesigned blur-solve's order equals fb_blur_solve_plain
    bitwise: odd and even winsizes (the main paths' 48 and 64, the
    run-time 15, one past the parent kernel's ceiling), on ragged sizes of
    one and several blocks."""
    rng = np.random.default_rng(winsize + out_hw[0])
    mp = torch.tensor(rng.normal(size=(5, out_hw[0] + winsize - 1,
                                       out_hw[1] + winsize - 1)), dtype=F32)
    mp[1] *= 0.2  # m12 small against m11, m22: a well-conditioned field
    mp[0].abs_().add_(0.5)
    mp[2].abs_().add_(0.5)
    want = fb_kernels.fb_blur_solve_plain(mp, winsize)
    _assert_bitwise(_blur_blocked(mp, winsize), want)


def test_blur_geometry_matches_cuda_source():
    """(f) The wrapper's blur tile, threads, accumulators and channel group
    are the source's; one horizontal item a thread; the compiled winsizes
    are blur_kernel_for's cases."""
    c = _cu_constants("fb_kernels")
    assert (c["BH"], c["BW"], c["BR"], c["B_THREADS"], c["B_GROUP"]) == (
        fb_kernels.TILE_H, fb_kernels.TILE_W, fb_kernels.BLUR_ACC,
        fb_kernels.THREADS, fb_kernels.BLUR_GROUP)
    assert "constexpr int BV = BH;" in (CSRC / "fb_kernels.cu").read_text()
    assert fb_kernels.BLUR_ROWS_ACC == fb_kernels.TILE_H
    assert (fb_kernels.TILE_H * fb_kernels.TILE_W // fb_kernels.BLUR_ACC
            == fb_kernels.THREADS)
    src = (CSRC / "fb_kernels.cu").read_text()
    body = src[src.index("BlurFn blur_kernel_for("):]
    body = body[:body.index("\n}\n")]
    cases = re.findall(r"case (\d+): return fb_blur_solve_kernel<(\d+)>;",
                       body)
    assert all(a == b for a, b in cases)
    assert tuple(int(a) for a, _ in cases) == \
        fb_kernels.BLUR_COMPILED_WINSIZES
    assert "return fb_blur_solve_kernel<0>;" in body
    for w in (1, 15, 47, 200):
        assert fb_kernels.blur_instantiation(w) == 0
    for w in fb_kernels.BLUR_COMPILED_WINSIZES:
        assert fb_kernels.blur_instantiation(w) == w
    for w in (15, 48, 64):
        smem = fb_kernels.blur_smem_bytes(w)
        assert smem == 4 * 5 * 16 * ((128 + w - 1) | 1)
        assert _blocks_by_smem(smem) >= 3
