"""Pyramidal Lucas-Kanade: sparse point tracking and a dense field.

Port of :mod:`tpuflow.solvers.lucas_kanade` (``LucasKanadeOF.cpp:50-114``:
goodFeaturesToTrack(500, 0.01, 10) seeding, calcOpticalFlowPyrLK
tracking, accept ``status && |dx| + |dy| > 2``; the same tracker runs in
``VideoFeaturesOF``'s stream):

- :func:`good_features_to_track` — the Shi-Tomasi minimum-eigenvalue
  response on the image's device (gradients and block sums through
  ``sep_conv2d``: five launches of the sepconv kernel on a CUDA tensor),
  then tpuflow's host code unchanged: 3x3 non-maximum suppression, the
  quality threshold, the sort and the greedy grid suppression.
- :func:`track_points` — Bouguet's pyramidal LK over all N points at
  once, as tpuflow's ``vmap``: per level each point's (win + 2)^2 prev
  patch by bilinear gather, its Sobel/8 gradients and the 2x2 structure
  tensor G once, then at most ``iters`` Newton steps d += G^-1 b. A point
  that is done (det <= 1e-12, or step^2 < eps^2) keeps its d, which is
  what the vmapped ``while_loop`` computes. The host reads the done mask
  back once every :data:`DONE_CHECK_EVERY` steps, never per step.
- :func:`dense_lucas_kanade` — per-pixel windowed LK from box-summed
  structure tensors, coarse-to-fine: the gradients and the five box sums
  a level plus two per iteration through ``sep_conv2d`` (33 sepconv
  launches at the defaults), the warp a clamped bilinear gather.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.core import borders as bd
from tpuflow_torch.ops.filters import box_filter, sep_conv2d
from tpuflow_torch.pyramid import pyramider, upsample_nearest

#: Newton steps between two reads of the points' done mask in
#: :func:`track_points` (the only host syncs of its loop). Any value gives
#: tpuflow's iterate: a done point is frozen, so extra steps change nothing.
DONE_CHECK_EVERY = 5

_D = (-0.5, 0.0, 0.5)  # central difference
_S = (0.0, 1.0, 0.0)   # identity


# ---------------------------------------------------------------------------
# Shi-Tomasi corners


def structure_tensor(img: torch.Tensor, block_size: int = 3):
    """(sxx, syy, sxy): the central-difference gradients' products, each
    box-summed over ``block_size`` (REFLECT101 borders throughout)."""
    ix = sep_conv2d(img, _D, _S, border=bd.REFLECT101)
    iy = sep_conv2d(img, _S, _D, border=bd.REFLECT101)
    return tuple(box_filter(a * b, block_size, border=bd.REFLECT101)
                 for a, b in ((ix, ix), (iy, iy), (ix, iy)))


def min_eigenvalue_response(img: torch.Tensor,
                            block_size: int = 3) -> torch.Tensor:
    """Shi-Tomasi min-eigenvalue of the block-summed structure tensor."""
    sxx, syy, sxy = structure_tensor(img, block_size)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = torch.sqrt(torch.clamp_min(tr * tr / 4.0 - det, 0.0))
    return tr / 2.0 - disc


def good_features_to_track(
    img: torch.Tensor,
    max_corners: int = 500,
    quality_level: float = 0.01,
    min_distance: float = 10.0,
    block_size: int = 3,
) -> np.ndarray:
    """OpenCV-style corner seeding; returns (N, 2) float64 (x, y) points."""
    from scipy.ndimage import maximum_filter

    resp = min_eigenvalue_response(img, block_size).cpu().numpy()
    thresh = quality_level * resp.max()
    peaks = (resp == maximum_filter(resp, size=3)) & (resp > thresh)
    ys, xs = np.nonzero(peaks)
    order = np.argsort(resp[ys, xs])[::-1]
    ys, xs = ys[order], xs[order]
    # Greedy min-distance suppression on a coarse grid (OpenCV's approach).
    cell = max(int(min_distance), 1)
    taken: dict[tuple[int, int], list[tuple[float, float]]] = {}
    out = []
    md2 = min_distance * min_distance
    for x, y in zip(xs, ys):
        cx, cy = x // cell, y // cell
        ok = all((px - x) ** 2 + (py - y) ** 2 >= md2
                 for gy in range(cy - 1, cy + 2)
                 for gx in range(cx - 1, cx + 2)
                 for px, py in taken.get((gx, gy), ()))
        if ok:
            taken.setdefault((cx, cy), []).append((float(x), float(y)))
            out.append((float(x), float(y)))
            if len(out) >= max_corners:
                break
    return np.array(out, dtype=np.float64).reshape(-1, 2)


# ---------------------------------------------------------------------------
# Pyramidal point tracking


def _bilinear_window(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                     win: int) -> torch.Tensor:
    """(N, win, win) windows centred at the float points (cx, cy), (N,)
    each, read bilinearly with clamped borders."""
    r = win // 2
    offs = torch.arange(-r, r + 1, dtype=img.dtype, device=img.device)
    xs = cx[:, None] + offs  # (N, win)
    ys = cy[:, None] + offs
    x0 = torch.floor(xs).long()
    y0 = torch.floor(ys).long()
    fx = (xs - x0)[:, None, :]
    fy = (ys - y0)[:, :, None]

    def g(yy, xx):
        return bd.gather2d(img, xx[:, None, :], yy[:, :, None], bd.CLAMP)

    p00 = g(y0, x0)
    p10 = g(y0, x0 + 1)
    p01 = g(y0 + 1, x0)
    p11 = g(y0 + 1, x0 + 1)
    return ((1 - fx) * (1 - fy) * p00 + fx * (1 - fy) * p10
            + (1 - fx) * fy * p01 + fx * fy * p11)


def _lk_refine_level(prev_l, next_l, pts, guess, win, iters, eps):
    """One pyramid level of Bouguet LK for (N, 2) points ``pts`` from the
    (N, 2) displacement ``guess``; returns (d, ok), (N, 2) and (N,)."""
    px, py = pts[:, 0], pts[:, 1]
    # Spatial gradients of the prev window (Sobel/8, computed once).
    patch = _bilinear_window(prev_l, px, py, win + 2)
    ix = (patch[:, 1:-1, 2:] - patch[:, 1:-1, :-2]) * 0.25 \
        + (patch[:, :-2, 2:] - patch[:, :-2, :-2]) * 0.125 \
        + (patch[:, 2:, 2:] - patch[:, 2:, :-2]) * 0.125
    iy = (patch[:, 2:, 1:-1] - patch[:, :-2, 1:-1]) * 0.25 \
        + (patch[:, 2:, :-2] - patch[:, :-2, :-2]) * 0.125 \
        + (patch[:, 2:, 2:] - patch[:, :-2, 2:]) * 0.125
    tpl = patch[:, 1:-1, 1:-1]
    gxx = torch.sum(ix * ix, dim=(1, 2))
    gxy = torch.sum(ix * iy, dim=(1, 2))
    gyy = torch.sum(iy * iy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    ok = det > 1e-12
    det_safe = torch.where(ok, det, 1.0)

    d = guess
    done = torch.zeros_like(ok)
    for n in range(iters):
        if n and n % DONE_CHECK_EVERY == 0 and bool(done.all()):  # host sync
            break
        cur = _bilinear_window(next_l, px + d[:, 0], py + d[:, 1], win)
        di = tpl - cur
        bx = torch.sum(ix * di, dim=(1, 2))
        by = torch.sum(iy * di, dim=(1, 2))
        dx = (gyy * bx - gxy * by) / det_safe
        dy = (gxx * by - gxy * bx) / det_safe
        step = torch.where(ok[:, None], torch.stack([dx, dy], dim=1), 0.0)
        d = torch.where(done[:, None], d, d + step)
        done = done | ~ok | (dx * dx + dy * dy < eps * eps)
    return d, ok


def track_points(
    prev: torch.Tensor,
    next: torch.Tensor,
    points,
    win: int = 21,
    max_level: int = 3,
    iters: int = 30,
    eps: float = 0.01,
):
    """Pyramidal LK: track (N, 2) (x, y) ``points`` from prev to next.

    Returns (new_points (N, 2), status (N,) bool) on the frames' device,
    the points in the frames' dtype. Mirrors calcOpticalFlowPyrLK's
    defaults (winSize 21, maxLevel 3, 30 iterations / 0.01 eps
    termination). Status: the structure tensor was invertible at every
    level and the tracked point lies in the frame.
    """
    prev_levels = pyramider(prev, max_level)
    next_levels = pyramider(next, max_level)
    pts = torch.as_tensor(np.asarray(points), dtype=prev.dtype,
                          device=prev.device).reshape(-1, 2)
    d = torch.zeros_like(pts)
    ok_all = torch.ones(pts.shape[0], dtype=torch.bool, device=prev.device)
    for lev in range(len(prev_levels) - 1, -1, -1):
        d, ok = _lk_refine_level(prev_levels[lev], next_levels[lev],
                                 pts * 0.5**lev, d, win, iters, eps)
        ok_all = ok_all & ok
        if lev > 0:
            d = d * 2.0
    new_pts = pts + d
    h, w = prev.shape
    inb = ((new_pts[:, 0] >= 0) & (new_pts[:, 0] < w)
           & (new_pts[:, 1] >= 0) & (new_pts[:, 1] < h))
    return new_pts, ok_all & inb


def accept_tracked_point(old_pts, new_pts, status, min_motion: float = 2.0):
    """The demo's acceptance rule (LucasKanadeOF.cpp:104-114):
    status && |dx| + |dy| > min_motion. Takes tensors or arrays; returns a
    bool tensor on ``new_pts``'s device."""
    new = torch.as_tensor(new_pts)
    old = torch.as_tensor(old_pts, dtype=new.dtype, device=new.device)
    d = (new - old).abs()
    return torch.as_tensor(status, device=new.device) & (
        d[:, 0] + d[:, 1] > min_motion)


# ---------------------------------------------------------------------------
# Dense LK


def _warp(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """img read bilinearly at (x + u, y + v), clamped borders."""
    h, w = img.shape
    gx = torch.arange(w, dtype=img.dtype, device=img.device)[None, :] + u
    gy = torch.arange(h, dtype=img.dtype, device=img.device)[:, None] + v
    x0 = torch.floor(gx).long()
    y0 = torch.floor(gy).long()
    fx = gx - x0
    fy = gy - y0

    def g(yy, xx):
        return bd.gather2d(img, xx, yy, bd.CLAMP)

    return ((1 - fx) * (1 - fy) * g(y0, x0)
            + fx * (1 - fy) * g(y0, x0 + 1)
            + (1 - fx) * fy * g(y0 + 1, x0)
            + fx * fy * g(y0 + 1, x0 + 1))


def dense_lucas_kanade(
    prev: torch.Tensor,
    next: torch.Tensor,
    win: int = 15,
    levels: int = 3,
    iters: int = 3,
    eps_det: float = 1e-6,
):
    """Dense coarse-to-fine LK: per-pixel windowed 2x2 normal equations.

    Structure tensors are box sums (separable correlations); the warp
    between iterations is a bilinear gather. Returns (u, v) on the frames'
    device.
    """
    prev_levels = pyramider(prev, levels - 1)
    next_levels = pyramider(next, levels - 1)
    u = torch.zeros_like(prev_levels[-1])
    v = torch.zeros_like(prev_levels[-1])
    area = win * win

    def box(f):
        return box_filter(f, win, border=bd.ZERO) * area

    for lev in range(levels - 1, -1, -1):
        p_l = prev_levels[lev]
        n_l = next_levels[lev]
        h, w = p_l.shape
        if u.shape != p_l.shape:
            u = 2.0 * upsample_nearest(u, (h, w))
            v = 2.0 * upsample_nearest(v, (h, w))
        ix = sep_conv2d(p_l, _D, _S, border=bd.REFLECT101)
        iy = sep_conv2d(p_l, _S, _D, border=bd.REFLECT101)
        sxx = box(ix * ix)
        sxy = box(ix * iy)
        syy = box(iy * iy)
        det = sxx * syy - sxy * sxy
        good = det > eps_det
        det_safe = torch.where(good, det, 1.0)
        for _ in range(iters):
            it = _warp(n_l, u, v) - p_l
            bx = -box(ix * it)
            by = -box(iy * it)
            du = (syy * bx - sxy * by) / det_safe
            dv = (sxx * by - sxy * bx) / det_safe
            u = u + torch.where(good, du, 0.0)
            v = v + torch.where(good, dv, 0.0)
    return u, v
