"""Histograms of Oriented Gradients and brute-force HOG matching flow
(port of :mod:`tpuflow.features.hog`; ``HOG/HOG.cpp``,
``HOG/HOG_struct.h``, ``HOG/HOG_match.cpp``).

- :func:`orientation` — central-difference gradients (zero beyond the
  border), magnitude ``sqrt(gx^2+gy^2)`` and the bin index from
  ``atan2/pi`` folded to [0, 1) unsigned or rescaled signed
  (HOG.cpp:66-118);
- :func:`compute_hog` — per-cell (7x7) magnitude-weighted histograms,
  tiled (``dense=False``) or sliding one pixel at a time (``dense=True``,
  differences of a 2-D prefix sum);
- :func:`block_normalize` — the dense-trajectories block normalization
  (3x3 blocks of cells 4 apart, L2 with eps 1e-6, HOG.cpp:234-292), and
  :func:`block_normalize_integral`, the intended math of the dead 3-arg
  overload (HOG.cpp:171-232; tpuflow's docstring lists its defects);
- :func:`hog_matching` — per site the nearest and second-nearest L2
  descriptor over a 65x65 window, score ``(d2-d1)/(d1+1e-6)``
  (HOG_match.cpp:9-75).

All of it is plain PyTorch on the frame's device (no TPU kernel stands
behind it). Sums whose grouping matters are taken in a fixed order of
elementwise adds, XLA's CPU order (``numerics.scan_cumsum``,
``numerics.window_sum``; the cell sums row by row, then column by
column): they give tpuflow's bits at float64 (descriptors of more than
32 values, i.e. 4 or more bins) and the same bits on the card as on the
CPU, so the card picks the CPU's winners. The angle's ``atan2`` is taken
on the host on both (``numerics.atan2``: the card's rounds otherwise,
and a bin boundary turns an ulp into another bin). The magnitude's
``gx*gx + gy*gy`` and the signed angle's ``atan2 * (1/pi) + 1`` are
rounded once, as XLA's CPU compiler fuses them (``numerics.fma``): an exact
diagonal gradient sits on a bin boundary, and the fused rounding puts it
in tpuflow's bin. PyTorch's CPU ``atan2`` and XLA's can round apart (a
bin moves only if its boundary falls inside that ulp). The block
normalization divides by a correctly rounded root, where XLA's CPU
rewrites ``1 / sqrt`` into its ``rsqrt``, which is not correctly
rounded: tpuflow's normalized descriptors differ from the port's in the
last bit or two.

:func:`hog_matching` runs tpuflow's ``fori_loop`` over the window's
offsets (row by row, -search/2 .. search/2 - 1 each way) with the same
carry update per offset: a strictly smaller distance takes the best
place and pushes the old best to second, a tie leaves ``d2 == d1``. The
distances of MATCH_CHUNK consecutive offsets of one row are computed at
once, channel-major, from a zero-padded copy of the current grid (a
strided view per chunk, no copy): the padding stands where tpuflow's
``roll`` wraps, and those sites are masked out in both. Scratch memory
is :data:`MATCH_CHUNK` x the descriptor grid (2 GB in float32 on a
376x1240 frame's dense grid).
"""

from __future__ import annotations

import math

import torch

from tpuflow_torch.utils import numerics
from tpuflow_torch.utils.numerics import true_div, window_sum

CELL = (7, 7)          # HOG.cpp:12
BLOCKSIZE = (3, 3)     # HOG.cpp:13
DISTANCE = (4, 4)      # HOG.cpp:14
MATCH_CHUNK = 8        # offsets whose distances are computed together
MATCH_EP = 1.0e-6
MATCH_BIG = 1.0e10     # distance of a candidate outside the grid


def orientation(img: torch.Tensor, bins: int = 16, signed: bool = False):
    """(magnitude, orient) per pixel (Orientation, HOG.cpp:66-118)."""
    z = torch.zeros_like(img)
    right = torch.cat([img[:, 1:], z[:, :1]], dim=1)
    left = torch.cat([z[:, :1], img[:, :-1]], dim=1)
    down = torch.cat([img[1:, :], z[:1, :]], dim=0)
    up = torch.cat([z[:1, :], img[:-1, :]], dim=0)
    gx = right - left
    gy = down - up
    # XLA's CPU compiler fuses this into fma(gx, gx, gy * gy): the same
    # single rounding here gives tpuflow's bits.
    magnitude = numerics.sqrt(numerics.fma(gx, gx, gy * gy))
    # XLA's CPU compiler turns tpuflow's atan2 / pi into a product with
    # the rounded reciprocal, and fuses the signed form's + 1 into it.
    theta = numerics.atan2(gy, gx)
    recip = true_div(torch.ones((), dtype=theta.dtype), math.pi).to(
        theta.device)
    if signed:
        angle = numerics.fma(theta, recip, torch.ones_like(theta)) / 2.0
    else:
        t = theta * recip
        angle = torch.where(t < 0.0, 1.0 + t, t)
    orient = torch.floor(bins * angle).to(torch.int32)
    orient = torch.where(orient == bins, 0, orient)
    return magnitude, orient


def compute_hog(magnitude: torch.Tensor, orient: torch.Tensor,
                bins: int = 16, cell: tuple[int, int] = CELL,
                dense: bool = False) -> torch.Tensor:
    """(Ch, Cw, bins) cell histograms
    (ComputeHistogramsOfOrientedGradients, HOG.cpp:121-168)."""
    h, w = magnitude.shape
    cw, chh = cell
    onehot = orient[..., None] == torch.arange(bins, device=orient.device)
    weighted = torch.where(onehot, magnitude[..., None], 0.0)
    if not dense:
        cells_w = w // cw
        cells_h = h // chh
        crop = weighted[: cells_h * chh, : cells_w * cw].reshape(
            cells_h, chh, cells_w, cw, bins)
        acc = None
        for i in range(chh):
            for j in range(cw):
                term = crop[:, i, :, j]
                acc = term if acc is None else acc + term
        return acc
    # dense: sliding (chh, cw) window sums, valid region only.
    c = numerics.scan_cumsum(numerics.scan_cumsum(weighted, 0), 1)
    c = torch.nn.functional.pad(c, (0, 0, 1, 0, 1, 0))
    return (c[chh:, cw:] - c[:-chh, cw:] - c[chh:, :-cw] + c[:-chh, :-cw])


def _normalize(stacked: torch.Tensor, reciprocal: bool) -> torch.Tensor:
    """L2-normalize the last axis with eps^2 = 1e-12 (its sum of squares
    in XLA's CPU order)."""
    norm = window_sum(stacked * stacked, -1)[..., None] + 1.0e-12
    if reciprocal:
        return stacked * (1.0 / numerics.sqrt(norm))
    return stacked / numerics.sqrt(norm)


def block_normalize(hog: torch.Tensor, blocksize: tuple[int, int] = BLOCKSIZE,
                    distance: tuple[int, int] = DISTANCE) -> torch.Tensor:
    """Dense-trajectories block normalization (HOG.cpp:234-292).

    hog: (Ch, Cw, bins) -> (Ch - 2*my, Cw - 2*mx, bw*bh*bins) with
    margin m = (blocksize-1)/2 * distance.
    """
    bw, bh = blocksize
    dx, dy = distance
    ch, cw, bins = hog.shape
    mx = (bw - 1) // 2 * dx
    my = (bh - 1) // 2 * dy
    oh = ch - 2 * my
    ow = cw - 2 * mx
    if oh <= 0 or ow <= 0:
        raise ValueError(
            f"HOG grid {ch}x{cw} too small for block normalization "
            f"(needs > {2 * my}x{2 * mx}); use dense=True on small images")
    taps = [hog[m * dy : m * dy + oh, n * dx : n * dx + ow]
            for m in range(bh) for n in range(bw)]
    return _normalize(torch.cat(taps, dim=-1), reciprocal=True)


def block_normalize_integral(
        hog: torch.Tensor,
        blocksize: tuple[int, int] = BLOCKSIZE) -> torch.Tensor:
    """Intended behavior of the dead 3-arg HOG_BlockNormalize
    (HOG.cpp:171-232): (Ch, Cw, bins) -> (Ch - bh + 1, Cw - bw + 1,
    bw*bh*bins), each output site stacking the contiguous bh x bw
    histogram block, L2-normalized with eps 1e-6."""
    bw, bh = blocksize
    ch, cw, bins = hog.shape
    oh = ch - (bh - 1)
    ow = cw - (bw - 1)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"HOG grid {ch}x{cw} smaller than block "
                         f"{bh}x{bw}")
    taps = [hog[m : m + oh, n : n + ow]
            for m in range(bh) for n in range(bw)]
    return _normalize(torch.cat(taps, dim=-1), reciprocal=False)


def hog_descriptor(img: torch.Tensor, bins: int = 16, signed: bool = False,
                   dense: bool = False):
    """Full pipeline: (cell_hog, normalized_block_hog)
    (HistogramsOfOrientedGradients, HOG.cpp:5-63)."""
    magnitude, orient = orientation(img, bins, signed)
    hog = compute_hog(magnitude, orient, bins, CELL, dense)
    return hog, block_normalize(hog, BLOCKSIZE, DISTANCE)


def match_offsets(search_w: int = 65, search_h: int = 65) -> list:
    """The window's (yc, xc) offsets in tpuflow's order: rows outer."""
    return [(yc, xc) for yc in range(-(search_h // 2), search_h // 2)
            for xc in range(-(search_w // 2), search_w // 2)]


def match_init(h: int, w: int, like: torch.Tensor):
    """The scan's starting carry (d1, d2, bx, by)."""
    big = torch.full((h, w), MATCH_BIG, dtype=like.dtype, device=like.device)
    z = torch.zeros((h, w), dtype=like.dtype, device=like.device)
    return big, big.clone(), z, z.clone()


def _runs(offsets, chunk: int):
    """Consecutive offsets of one row, at most ``chunk`` each."""
    run = []
    for yc, xc in offsets:
        if run and (yc != run[0][0] or xc != run[-1][1] + 1
                    or len(run) == chunk):
            yield run
            run = []
        run.append((yc, xc))
    if run:
        yield run


def match_scan(feat_prv: torch.Tensor, feat_cur: torch.Tensor, offsets,
               carry, chunk: int = MATCH_CHUNK):
    """tpuflow's per-offset carry update over ``offsets`` in their order,
    from ``carry`` (d1, d2, bx, by). An offset beyond the grid on either
    axis (a mesh's padding sentinel) leaves every site's distance at the
    out-of-window value, which changes no carry: it is skipped."""
    h, w, d = feat_prv.shape
    offsets = [(yc, xc) for yc, xc in offsets if abs(yc) < h and abs(xc) < w]
    if not offsets:
        return carry
    ry = max(abs(yc) for yc, _ in offsets)
    rx = max(abs(xc) for _, xc in offsets)
    prv = feat_prv.permute(2, 0, 1).contiguous()            # (D, h, w)
    cur = torch.nn.functional.pad(feat_cur.permute(2, 0, 1),
                                  (rx, rx, ry, ry)).contiguous()
    hp, wp = cur.shape[-2:]
    ys = torch.arange(h, device=prv.device)[:, None]
    xs = torch.arange(w, device=prv.device)[None, :]
    big = torch.full((), MATCH_BIG, dtype=prv.dtype, device=prv.device)
    d1, d2, bx, by = carry
    for run in _runs(offsets, chunk):
        yc, xc0 = run[0]
        # (B, D, h, w): offset b reads cur at (y + yc, x + xc0 + b).
        view = cur.as_strided(
            (len(run), d, h, w), (1, hp * wp, wp, 1),
            cur.storage_offset() + (ry + yc) * wp + rx + xc0)
        diff = prv[None] - view
        ssq = window_sum(diff.mul_(diff), 1)                # (B, h, w)
        dists = numerics.sqrt(ssq)
        row_ok = (ys + yc >= 0) & (ys + yc < h)
        for b, (_, xc) in enumerate(run):
            valid = row_ok & (xs + xc >= 0) & (xs + xc < w)
            dist = torch.where(valid, dists[b], big)
            better1 = dist < d1
            better2 = ~better1 & (dist < d2)
            d2 = torch.where(better1, d1, torch.where(better2, dist, d2))
            d1 = torch.where(better1, dist, d1)
            bx = torch.where(better1, float(xc), bx)
            by = torch.where(better1, float(yc), by)
    return d1, d2, bx, by


def match_score(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    return (d2 - d1) / (d1 + MATCH_EP)


def hog_matching(feat_prv: torch.Tensor, feat_cur: torch.Tensor,
                 search_w: int = 65, search_h: int = 65):
    """(u, v, score) per grid site (HOG_Matching, HOG_match.cpp:9-75).

    feat_*: (H, W, D) descriptor grids. Offsets sweep
    [-search/2, search/2) (the reference's asymmetric exclusive upper
    bound); candidates leaving the grid are skipped.
    """
    h, w, _ = feat_prv.shape
    d1, d2, bx, by = match_scan(feat_prv, feat_cur,
                                match_offsets(search_w, search_h),
                                match_init(h, w, feat_prv))
    return bx, by, match_score(d1, d2)
