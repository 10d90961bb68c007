"""The arithmetic forms the CUDA sweep kernels rely on, on the CPU.

The kernels themselves run only on the card, where chip_smoke.py holds
them bitwise to their plain versions. These tests check, in float32 and
bitwise (``torch.equal``), that the reorganised forms the kernels compute
are the plain versions' arithmetic:

- (a) the region-gated neighbour term of an edge, computed at either end,
  is the exact negation of the other end's (``csrc/irls_gated.cu``
  computes each edge once);
- (b) a test-local edge form of the gated sweep (each edge once, added at
  one end and subtracted at the other, in the plain neighbour order)
  equals ``irls_gated_sweeps_plain``;
- (c) column sums computed once and then summed W along the row, from 0,
  equal ``_box_sum``, and the HS sweeps built on them equal
  ``hs_sweeps_plain`` and ``hs_tile_sweeps_plain`` (``csrc/hs_stencil.cu``);
- (d) the launch geometry: the Python constants match the CUDA sources,
  the shared memory fits a block, and the blocks per SM the designs intend
  hold by arithmetic (228 KB per SM, 1 KB reserved per block);
- (e) a test-local edge form of the Black-Anandan sweep (each right and
  down edge once where both ends are in the frame, then per cell the left
  edge subtracted, the right added, the upper subtracted, the down added,
  as ``csrc/irls_stencil.cu`` computes it on a staged tile) equals
  ``irls_sweeps_plain`` and ``irls_tile_sweeps_plain``, on fields with
  exact zeros and equal neighbours, where a wrong sign of zero would show;
- (f) a test-local emulation of ``csrc/sepconv.cu``'s register-blocked
  passes (blocks of TILE_H x TILE_W outputs, ACC accumulators a thread fed
  a streamed column, then a streamed row, the inputs taken ACC at a time
  as the kernel's registers hold them) equals ``sep_conv2d_valid_plain``,
  and every tap count up to MAX_TAPS fits a block.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuflow_torch.core import borders as bd
from tpuflow_torch.kernels import hs_stencil, irls_stencil, sepconv
from tpuflow_torch.kernels import _build
from tpuflow_torch.kernels._build import MAX_SMEM_BYTES
from tpuflow_torch.solvers import bm_flow
from tpuflow_torch.solvers.mestimators import geman_mcclure_psi as psi
from tpuflow_torch.utils import numerics

CSRC = Path(irls_stencil.__file__).resolve().parent.parent / "csrc"
SIGMA_S = bm_flow.SIGMA_S_BM
GATED_ARGS = (bm_flow.LAMBDA_D, bm_flow.LAMBDA_S, bm_flow.SIGMA_D_BM,
              bm_flow.SIGMA_S_BM)
# Hopper: shared memory per SM and per block, threads per SM.
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED_PER_BLOCK = 1024
THREADS_PER_SM = 2048


def _f32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _term(u, v, dx, dy):
    """The plain version's gated neighbour term for neighbour (dx, dy),
    at every cell, for u and v (``_neighbor_terms`` before the gate)."""
    norm_c = torch.sqrt(u * u + v * v)
    un, vn, coeff = bm_flow._coherence(u, v, norm_c, dx, dy)
    return coeff * psi(u - un, SIGMA_S), coeff * psi(v - vn, SIGMA_S)


def _fields(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        u, v = 0.2 * rng.normal(size=shape), 0.2 * rng.normal(size=shape)
    elif kind == "zero":
        u, v = np.zeros(shape), np.zeros(shape)
    elif kind == "denormal":
        u = rng.normal(size=shape) * 1e-39
        v = rng.normal(size=shape) * 1e-40
    else:  # equal vectors
        u = np.full(shape, 0.3)
        v = np.full(shape, -0.7)
    return _f32(u), _f32(v)


@pytest.mark.parametrize("kind", ["random", "zero", "denormal", "equal"])
@pytest.mark.parametrize("edge", ["horizontal", "vertical"])
def test_edge_term_antisymmetric(edge, kind):
    """(a) The term at c for q is the exact negation of the term at q for
    c, in float32."""
    u, v = _fields(kind, (23, 31), 11)
    if kind == "denormal":
        assert 0 < float(u.abs().max()) < torch.finfo(torch.float32).tiny
    if edge == "horizontal":
        near, far = _term(u, v, 1, 0), _term(u, v, -1, 0)
        cut_near, cut_far = np.s_[:, :-1], np.s_[:, 1:]
    else:
        near, far = _term(u, v, 0, 1), _term(u, v, 0, -1)
        cut_near, cut_far = np.s_[:-1, :], np.s_[1:, :]
    for a, b in zip(near, far):
        assert torch.equal(b[cut_far], -a[cut_near])
    if kind == "random":
        assert float(near[0][cut_near].abs().max()) > 0


def _edge_form_sweeps(u, v, gx, gy, it, labels, sup_x, sup_y, fuse,
                      lambda_d, lambda_s, sigma_d, sigma_s):
    """The gated sweeps as csrc/irls_gated.cu computes them: each cell's
    norm once, each right and down edge once, then per cell the left edge
    subtracted, the right edge added, the upper edge subtracted, the down
    edge added (the plain order), each only where its gate is on."""
    left, right, up, down = (g.bool() for g in bm_flow._region_gates(
        labels, u.dtype))
    for _ in range(fuse):
        norm = numerics.sqrt(u * u + v * v)  # sqrtf: correctly rounded
        edges = {}
        for name, (dx, dy) in (("right", (1, 0)), ("down", (0, 1))):
            un, vn, m = bm_flow._coherence(u, v, norm, dx, dy)
            edges[name] = (m * psi(u - un, sigma_s), m * psi(v - vn, sigma_s))
        psi_d = psi(gx * u + gy * v + it, sigma_d)
        sums = []
        for k in range(2):
            s = torch.zeros_like(u)
            from_left = bm_flow._shift_field(edges["right"][k], -1, 0)
            from_up = bm_flow._shift_field(edges["down"][k], 0, -1)
            s = torch.where(left, s - from_left, s)
            s = torch.where(right, s + edges["right"][k], s)
            s = torch.where(up, s - from_up, s)
            s = torch.where(down, s + edges["down"][k], s)
            sums.append(s)
        u, v = (u - (lambda_d * gx * psi_d + lambda_s * sums[0]) / sup_x,
                v - (lambda_d * gy * psi_d + lambda_s * sums[1]) / sup_y)
    return u, v


def _small_regions(shape, seed):
    """Many small regions: random ids on 3x4 blocks, cut by a diagonal."""
    rng = np.random.default_rng(seed)
    h, w = shape
    ids = rng.integers(0, 5, (h // 3 + 1, w // 4 + 1))
    lab = np.repeat(np.repeat(ids, 3, 0), 4, 1)[:h, :w]
    yy, xx = np.mgrid[0:h, 0:w]
    return torch.from_numpy((lab + 7 * ((yy + xx) % 11 < 2)).astype(np.int32))


@pytest.mark.parametrize("fuse", [1, 16])
@pytest.mark.parametrize("shape", [(37, 53), (64, 96)])
@pytest.mark.parametrize("batch", [1, 2])
def test_edge_form_equals_gated_plain(batch, shape, fuse):
    """(b) The edge form equals irls_gated_sweeps_plain bitwise."""
    rng = np.random.default_rng(batch * 100 + shape[0] + fuse)
    lead = (batch,) if batch == 2 else ()
    u, v = (_f32(0.3 * rng.normal(size=lead + shape)) for _ in range(2))
    it = _f32(0.05 * rng.normal(size=lead + shape))
    gx, gy = (_f32(0.1 * rng.normal(size=shape)) for _ in range(2))
    labels = _small_regions(shape, fuse)
    assert len(torch.unique(labels)) > 8
    sups = (_f32([3.7]), _f32([4.1]))
    want = irls_stencil.irls_gated_sweeps_plain(u, v, gx, gy, it, labels,
                                                *sups, fuse, *GATED_ARGS)
    got = _edge_form_sweeps(u, v, gx, gy, it, labels, *sups, fuse,
                            *GATED_ARGS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(want[0], u)


def _colsum_box(a: torch.Tensor, window: int) -> torch.Tensor:
    """The box sum of a zero-padded field as csrc/hs_stencil.cu takes it:
    each column sum once (top to bottom), then W of them along the row,
    left to right, from 0."""
    r = window // 2
    p = bd.pad2d(a, r, bd.ZERO)
    h, w = a.shape
    cols = p[0:h, :]
    for d in range(1, window):
        cols = cols + p[d : d + h, :]
    out = torch.zeros_like(a)
    for d in range(window):
        out = out + cols[:, d : d + w]
    return out


@pytest.mark.parametrize("window", [3, 5, 7])
def test_column_sum_form_equals_box_sum(window):
    """(c) Once-computed column sums, then W along the row, equal _box_sum
    bitwise."""
    a = _f32(np.random.default_rng(window).normal(size=(29, 41)))
    assert torch.equal(_colsum_box(a, window), hs_stencil._box_sum(a, window))


def _colsum_hs_sweeps(u, v, gx, gy, gt, inv, window, fuse):
    inv_area = 1.0 / (window * window)
    for _ in range(fuse):
        ub = _colsum_box(u, window) * inv_area
        vb = _colsum_box(v, window) * inv_area
        upd = (gx * ub + gy * vb + gt) * inv
        u, v = ub - gx * upd, vb - gy * upd
    return u, v


def _colsum_tile_sweeps(u_p, v_p, gx, gy, gt, inv, row0, col0, img_h,
                        img_w, window, fuse):
    """The tile kernel's block on one halo'd tile: the valid region shrinks
    by r per sweep, column sums on its rows (and r more columns each side),
    then the row sums; cells outside the frame held at 0."""
    hh, hw = u_p.shape
    r = window // 2
    inv_area = 1.0 / (window * window)
    mask = hs_stencil._inside_mask(row0, col0, hh, hw, img_h, img_w, u_p)
    u, v = u_p * mask, v_p * mask
    for t in range(1, fuse + 1):
        lo = t * r
        rows, cols = slice(lo, hh - lo), slice(lo - r, hw - lo + r)
        new = []
        for f in (u, v):
            cs = f[lo - r : hh - lo - r, cols]
            for d in range(1, window):
                cs = cs + f[lo - r + d : hh - lo - r + d, cols]
            s = torch.zeros((hh - 2 * lo, hw - 2 * lo))
            for d in range(window):
                s = s + cs[:, d : d + hw - 2 * lo]
            new.append(s * inv_area)
        ub, vb = new
        core = (rows, slice(lo, hw - lo))
        upd = (gx[core] * ub + gy[core] * vb + gt[core]) * inv[core]
        u, v = u.clone(), v.clone()
        u[core] = (ub - gx[core] * upd) * mask[core]
        v[core] = (vb - gy[core] * upd) * mask[core]
    need = fuse * r
    return u[need : hh - need, need : hw - need], \
        v[need : hh - need, need : hw - need]


def _hs_fields(shape, seed):
    rng = np.random.default_rng(seed)
    gx, gy = rng.normal(size=shape), rng.normal(size=shape)
    u, v = 0.5 * rng.normal(size=shape), 0.5 * rng.normal(size=shape)
    return [_f32(a) for a in (u, v, gx, gy, 0.3 * rng.normal(size=shape),
                              1.0 / (1.0 + gx * gx + gy * gy))]


@pytest.mark.parametrize("window", [3, 5])
@pytest.mark.parametrize("kernel", ["sweeps", "tile"])
def test_column_sum_hs_equals_plain(kernel, window):
    """(c) The HS sweeps on column sums equal hs_sweeps_plain and
    hs_tile_sweeps_plain bitwise (the tile at a frame corner, so the
    inside mask and the ragged frame edge both act)."""
    fuse = 3
    if kernel == "sweeps":
        fields = _hs_fields((27, 45), window)
        want = hs_stencil.hs_sweeps_plain(*fields, window, fuse)
        got = _colsum_hs_sweeps(*fields, window, fuse)
    else:
        need = fuse * (window // 2)
        fields = _hs_fields((20 + 2 * need, 26 + 2 * need), window + 1)
        args = (-need, 30 - need, 18, 50, window, fuse)
        want = hs_stencil.hs_tile_sweeps_plain(*fields, *args)
        got = _colsum_tile_sweeps(*fields, *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _cu_constants(name: str) -> dict:
    src = (CSRC / f"{name}.cu").read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", src)}


def _cu_stages(name: str) -> dict:
    """{name: (SH, CX, CY, blocks per SM)} of ``using name = Stage<...>``."""
    src = (CSRC / f"{name}.cu").read_text()
    return {k: tuple(int(a) for a in args.split(","))
            for k, args in re.findall(r"using (\w+) = Stage<([\d, ]+)>;", src)}


def test_python_geometry_matches_cuda_sources():
    """(d) The wrappers' staged tiles and threads are the sources'."""
    g = _cu_constants("irls_gated")
    assert (g["SH"], 32 * g["CX"]) == irls_stencil.GATED_STAGE
    assert 32 * g["SH"] // g["CY"] == irls_stencil.GATED_THREADS
    s = _cu_stages("irls_stencil")
    for name, stage, threads in (
            ("WIDE", irls_stencil.STAGE, irls_stencil.THREADS),
            ("NARROW", irls_stencil.NARROW_STAGE,
             irls_stencil.NARROW_THREADS)):
        sh, cx, cy, blocks = s[name]
        assert (sh, 32 * cx) == stage and 32 * sh // cy == threads
        assert blocks == 1
    h = _cu_constants("hs_stencil")
    assert (h["SH"], 32 * h["CX"]) == hs_stencil.STAGE
    assert 32 * h["SH"] // h["CY"] == hs_stencil.THREADS
    assert h["BLOCKS_PER_SM"] == hs_stencil.BLOCKS_PER_SM


def _blocks_by_arithmetic(smem: int, threads: int) -> int:
    return min(SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK),
               THREADS_PER_SM // threads)


@pytest.mark.parametrize("fuse", range(1, 17))
def test_gated_geometry(fuse):
    """(d) Every fuse 1-16 leaves a core and fits one block's shared
    memory; one block of the gated kernel fits an SM."""
    core = irls_stencil.gated_core(fuse)
    assert min(core) >= 1
    smem = irls_stencil.smem_bytes_gated(fuse)
    assert smem <= MAX_SMEM_BYTES
    assert _blocks_by_arithmetic(smem, irls_stencil.GATED_THREADS) >= 1


@pytest.mark.parametrize("fuse", range(1, irls_stencil.MAX_FUSE + 2))
@pytest.mark.parametrize("kernel", ["irls_stencil", "irls_narrow",
                                    "irls_gated"])
def test_irls_geometry(kernel, fuse):
    """(d) Every fuse up to F_max leaves a core and fits one block's shared
    memory, with one block per SM; one deeper raises (the wrappers split
    it; csrc/irls_stencil.cu's launcher takes NARROW only where it leaves a
    core, so F_max is WIDE's)."""
    narrow = irls_stencil.NARROW_STAGE
    core, smem, f_max, threads = {
        "irls_stencil": (irls_stencil.stage_core, irls_stencil.smem_bytes,
                         irls_stencil.MAX_FUSE, irls_stencil.THREADS),
        "irls_narrow": (lambda f: _build.core("narrow", narrow, f),
                        lambda f: 6 * 4 * narrow[0] * narrow[1],
                        _build.max_halo(narrow), irls_stencil.NARROW_THREADS),
        "irls_gated": (irls_stencil.gated_core, irls_stencil.smem_bytes_gated,
                       irls_stencil.GATED_MAX_FUSE,
                       irls_stencil.GATED_THREADS)}[kernel]
    if fuse > f_max:
        with pytest.raises(ValueError, match="leaves no core"):
            core(fuse)
        return
    assert min(core(fuse)) >= 1
    assert smem(fuse) <= MAX_SMEM_BYTES
    assert _blocks_by_arithmetic(smem(fuse), threads) >= 1


def test_irls_stage_covers_kitti_in_one_wave():
    """(d) At BA's fuse 16 the 376x1240 frame takes 130 blocks of
    csrc/irls_stencil.cu, one wave of the H100's 132 SMs."""
    h, w = irls_stencil.stage_core(16)
    assert irls_stencil.MAX_FUSE >= 16
    assert -(-376 // h) * -(-1240 // w) == 130


@pytest.mark.parametrize("window", [3, 5, 7])
def test_hs_tile_geometry(window):
    """(d) tile_for accepts exactly the fuses that leave a core; each of
    them fits a block's shared memory, and two blocks fit an SM."""
    r = window // 2
    accepted = []
    for fuse in range(1, 40):
        try:
            core = hs_stencil.tile_for(window, fuse)
        except ValueError:
            assert min(hs_stencil.STAGE) - 2 * fuse * r < 1
            continue
        accepted.append(fuse)
        assert core == tuple(s - 2 * fuse * r for s in hs_stencil.STAGE)
        smem = hs_stencil.smem_bytes(window, fuse)
        assert smem <= MAX_SMEM_BYTES
        assert _blocks_by_arithmetic(smem, hs_stencil.THREADS) \
            >= hs_stencil.BLOCKS_PER_SM
    assert accepted == list(range(1, accepted[-1] + 1))
    assert 5 in accepted and (window > 5 or 10 in accepted)


def _irls_edge_form_tile(u_p, v_p, gx, gy, it, sup_x, sup_y, row0, col0,
                         img_h, img_w, fuse, lambda_d, lambda_s, sigma_d,
                         sigma_s):
    """csrc/irls_stencil.cu's sweeps on one staged tile, whose (0, 0) sits
    at frame coordinates (row0, col0): per sweep t, each right and down
    edge whose ends are both in the frame once, (psi(du), psi(dv)); then
    each cell of the valid region [t, size - t) that is in the frame adds
    -(left edge), +(right edge), -(upper edge), +(down edge), each where its
    neighbour is in the frame, and divides by sup. Returns the core."""
    hh, hw = u_p.shape
    ys = torch.arange(hh)[:, None] + row0
    xs = torch.arange(hw)[None, :] + col0
    live = (ys >= 0) & (ys < img_h) & (xs >= 0) & (xs < img_w)
    left, right, up, down = (torch.zeros_like(live) for _ in range(4))
    right[:, :-1] = live[:, :-1] & live[:, 1:]
    down[:-1, :] = live[:-1, :] & live[1:, :]
    left[:, 1:] = right[:, :-1]
    up[1:, :] = down[:-1, :]
    u, v = u_p.clone(), v_p.clone()
    for t in range(1, fuse + 1):
        edges = []
        for f in (u, v):
            r = torch.zeros_like(f)
            d = torch.zeros_like(f)
            r[:, :-1] = psi(f[:, :-1] - f[:, 1:], sigma_s)
            d[:-1, :] = psi(f[:-1, :] - f[1:, :], sigma_s)
            edges.append((r, d))
        psi_d = psi(gx * u + gy * v + it, sigma_d)
        sums = []
        for r, d in edges:
            from_left = torch.zeros_like(r)
            from_left[:, 1:] = r[:, :-1]
            from_up = torch.zeros_like(d)
            from_up[1:, :] = d[:-1, :]
            s = torch.zeros_like(r)
            s = torch.where(left, s + -from_left, s)
            s = torch.where(right, s + r, s)
            s = torch.where(up, s + -from_up, s)
            s = torch.where(down, s + d, s)
            sums.append(s)
        new_u = u - (lambda_d * gx * psi_d + lambda_s * sums[0]) / sup_x
        new_v = v - (lambda_d * gy * psi_d + lambda_s * sums[1]) / sup_y
        region = torch.zeros_like(live)
        region[t : hh - t, t : hw - t] = True
        region &= live
        u = torch.where(region, new_u, u)
        v = torch.where(region, new_v, v)
    return u[fuse : hh - fuse, fuse : hw - fuse], \
        v[fuse : hh - fuse, fuse : hw - fuse]


IRLS_ARGS = (5.0, 1.0, 0.3, 0.1)  # lambda_d, lambda_s, sigma_d, sigma_s
IRLS_SUPS = (_f32([41.5]), _f32([38.25]))


def _irls_fields(kind, shape, seed):
    """u, v, gx, gy, it in float32. ``patches``: random fields with a block
    of exact zeros and a block of one constant in u and v (equal neighbours:
    differences of +0), and zeros in gx and it; ``zero``: u = v = 0."""
    rng = np.random.default_rng(seed)
    h, w = shape
    u, v = 0.2 * rng.normal(size=shape), 0.2 * rng.normal(size=shape)
    gx, gy = rng.normal(size=shape), rng.normal(size=shape)
    it = 0.1 * rng.normal(size=shape)
    if kind == "patches":
        for f in (u, v):
            f[h // 4 : h // 2, w // 4 : w // 2] = 0.0
            f[h // 2 :, w // 2 :] = 0.125
        gx[: h // 3, :] = 0.0
        it[:, : w // 3] = 0.0
    elif kind == "zero":
        u[:], v[:] = 0.0, 0.0
    return [_f32(a) for a in (u, v, gx, gy, it)]


@pytest.mark.parametrize("fuse", [1, 15, 16, 17])
@pytest.mark.parametrize("kind", ["random", "patches", "zero"])
def test_irls_edge_form_equals_plain(kind, fuse):
    """(e) The whole ragged frame as the kernel stages it (a zero halo of
    fuse cells outside the frame) equals irls_sweeps_plain bitwise."""
    shape = (37, 53)
    u, v, gx, gy, it = _irls_fields(kind, shape, fuse)
    want = irls_stencil.irls_sweeps_plain(u, v, gx, gy, it, *IRLS_SUPS, fuse,
                                          *IRLS_ARGS)
    padded = [bd.pad2d(f, fuse, bd.ZERO) for f in (u, v, gx, gy, it)]
    got = _irls_edge_form_tile(*padded, *IRLS_SUPS, -fuse, -fuse, *shape,
                               fuse, *IRLS_ARGS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(want[0], u)


@pytest.mark.parametrize("origin", ["top_left", "bottom_right", "interior"])
@pytest.mark.parametrize("fuse", [1, 15, 16, 17])
@pytest.mark.parametrize("kind", ["random", "patches"])
def test_irls_edge_form_tile_equals_plain(kind, fuse, origin):
    """(e) A halo'd tile whose core sits at a corner or inside a ragged
    frame (halo cells outside the frame hold random values, which the
    sweeps must ignore) equals irls_tile_sweeps_plain bitwise."""
    img, core = (29, 41), (9, 14)
    cy, cx = {"top_left": (0, 0), "bottom_right": (20, 27),
              "interior": (10, 13)}[origin]
    shape = (core[0] + 2 * fuse, core[1] + 2 * fuse)
    fields = _irls_fields(kind, shape, 100 + fuse)
    args = (*IRLS_SUPS, cy - fuse, cx - fuse, *img, fuse, *IRLS_ARGS)
    want = irls_stencil.irls_tile_sweeps_plain(*fields, *args)
    got = _irls_edge_form_tile(*fields, *args)
    assert want[0].shape == core
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _sliding_taps(k, n, load, acc_n):
    """csrc/sepconv.cu's sliding_taps on tensors: acc[j] = sum_{d < n}
    k[d] * load(j + d), each sum from tap 0 in tap order, the inputs
    taken acc_n at a time into cur/nxt/pre as the kernel's registers."""
    inputs = acc_n + n - 1
    zero = torch.zeros_like(load(0))
    cur = [load(q) for q in range(acc_n)]
    nxt = [load(acc_n + q) if acc_n + q < inputs else zero
           for q in range(acc_n)]
    acc = [None] * acc_n
    for d in range(0, n, acc_n):
        pre = [load(d + 2 * acc_n + q) if d + 2 * acc_n + q < inputs
               else zero for q in range(acc_n)]
        for s in range(acc_n):
            if d + s < n:
                t = float(k[d + s])
                for j in range(acc_n):
                    x = cur[s + j] if s + j < acc_n else nxt[s + j - acc_n]
                    p = x * t
                    acc[j] = p if d + s == 0 else acc[j] + p
        cur, nxt = nxt, pre
    return acc


def _sepconv_blocked(padded, ky, kx):
    """csrc/sepconv.cu's two passes on every block of the grid at once:
    blocks of TILE_H x TILE_W outputs, the first pass on the block's
    TILE_W + nkx - 1 columns in row groups of ACC (inputs past the padded
    image read as 0), the second along each row in column groups of ACC."""
    th, tw, r = sepconv.TILE_H, sepconv.TILE_W, sepconv.ACC
    hp, wp = padded.shape
    nky, nkx = len(ky), len(kx)
    ho, wo = hp - nky + 1, wp - nkx + 1
    nby, nbx = -(-ho // th), -(-wo // tw)
    ncols = tw + nkx - 1
    p = torch.zeros((nby * th + nky - 1, nbx * tw + nkx - 1))
    p[:hp, :wp] = padded
    # (row group, block column, input q, column c) for the first pass.
    cols = p.unfold(0, r + nky - 1, r).unfold(1, ncols, tw)
    acc = _sliding_taps(ky, nky, lambda q: cols[:, :, q, :], r)
    rows = torch.stack(acc, 1).reshape(nby * th, nbx, ncols)
    # (row, block column, column group, input q) for the second pass.
    segs = rows.unfold(2, r + nkx - 1, r)
    assert segs.shape[2] == tw // r
    acc = _sliding_taps(kx, nkx, lambda q: segs[..., q], r)
    out = torch.stack(acc, -1).reshape(nby * th, nbx * tw)
    return out[:ho, :wo]


@pytest.mark.parametrize("out_shape", [(70, 150), (3, 131)])
@pytest.mark.parametrize("taps", [(1, 1), (3, 3), (9, 9), (15, 15),
                                  (17, 17), (48, 48), (64, 64), (128, 128),
                                  (15, 64), (48, 15), (128, 3)])
def test_sepconv_register_blocked_equals_plain(taps, out_shape):
    """(f) The redesigned sepconv order (register accumulators fed a
    streamed column, then a streamed row, in tap order) equals
    sep_conv2d_valid_plain bitwise, at every main-path tap count (the box's
    15, 48, 64, the pyramid blur's 3 and 9), the largest, mixed counts, and
    ragged sizes of one and several blocks."""
    nky, nkx = taps
    rng = np.random.default_rng(nky * 1000 + nkx)
    padded = _f32(rng.uniform(0, 255, (out_shape[0] + nky - 1,
                                       out_shape[1] + nkx - 1)))
    ky = sepconv.host_taps(rng.normal(size=nky), torch.float32)
    kx = sepconv.host_taps(rng.uniform(0.1, 1.0, nkx), torch.float32)
    got = _sepconv_blocked(padded, ky, kx)
    assert torch.equal(got, sepconv.sep_conv2d_valid_plain(padded, ky, kx))


def test_sepconv_geometry_matches_cuda_source():
    """(f) The wrapper's tile, threads and accumulators are the source's."""
    c = _cu_constants("sepconv")
    assert (c["TH"], c["TW"], c["THREADS"], c["R"]) == (
        sepconv.TILE_H, sepconv.TILE_W, sepconv.THREADS, sepconv.ACC)
    assert sepconv.TILE_H % sepconv.ACC == 0
    assert sepconv.TILE_W % sepconv.ACC == 0


def test_sepconv_compiled_counts_match_cuda_source():
    """(f) The tap counts compiled in are kernel_for's cases, each the same
    on both axes; every other pair, mixed pairs of compiled counts too,
    takes the run-time instantiation."""
    src = (CSRC / "sepconv.cu").read_text()
    body = src[src.index("SepFn kernel_for("):]
    body = body[:body.index("\n}\n")]
    cases = re.findall(r"case (\d+): return sep_conv2d_valid_kernel<(\d+), "
                       r"(\d+)>;", body)
    assert all(a == b == c for a, b, c in cases)
    assert tuple(int(a) for a, _, _ in cases) == sepconv.COMPILED_TAPS
    assert "return sep_conv2d_valid_kernel<0, 0>;" in body
    for n in sepconv.COMPILED_TAPS:
        assert sepconv.instantiation(n, n) == (n, n)
    for pair in ((3, 3), (9, 9), (17, 17), (48, 15), (15, 48), (128, 128)):
        assert sepconv.instantiation(*pair) == (0, 0)


def _sepconv_tap_count_fits(taps):
    smem = sepconv.smem_bytes(taps, taps)
    assert smem <= MAX_SMEM_BYTES
    assert _blocks_by_arithmetic(smem, sepconv.THREADS) >= 2
    pitch = (sepconv.TILE_W + taps - 1) | 1
    assert pitch % 2 == 1 and pitch >= sepconv.TILE_W + taps - 1
    assert len({(row * pitch) % 32 for row in range(32)}) == 32


SEPCONV_EDGE_TAPS = (1, 2, 3, 9, 15, 17, 48, 64, 127, 128)


@pytest.mark.parametrize("taps", SEPCONV_EDGE_TAPS)
def test_sepconv_tap_count_fits(taps):
    """(f) A tap count fits one block's shared memory with two blocks on
    an SM, and its first-pass rows have an odd pitch (the second pass's 32
    lanes on 32 rows hit 32 banks): the ends, the main paths' counts and
    the pitch's even and odd cases."""
    _sepconv_tap_count_fits(taps)


def test_sepconv_every_tap_count_fits():
    """(f) The same for every other tap count up to MAX_TAPS."""
    for taps in range(1, sepconv.MAX_TAPS + 1):
        if taps not in SEPCONV_EDGE_TAPS:
            _sepconv_tap_count_fits(taps)


@pytest.mark.parametrize("name", ["hs_stencil", "hs_resident"])
def test_build_hash_covers_the_shared_header(name):
    """(d) Both HS sources include csrc/hs_block.cuh, and the bytes their
    library's hash covers hold it, so an edited header rebuilds both."""
    header = (CSRC / "hs_block.cuh").read_bytes()
    src = CSRC / f"{name}.cu"
    assert b'#include "hs_block.cuh"' in src.read_bytes()
    assert header in _build.source_bytes(src)
