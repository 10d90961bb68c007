"""Farneback dense optical flow (port of :mod:`tpuflow.solvers.farneback`).

OpenCV's ``calcOpticalFlowFarneback`` parameterization, as the reference
demos call it (``FarnebackOF.cpp:24``, ``DenseFlow.cpp:37``,
``HornSchunckOF/main.cpp:111``):

- per-pixel quadratic expansion by Gaussian-weighted least squares over a
  (2 poly_n + 1)^2 window (:func:`poly_expansion`); by default through
  :mod:`tpuflow_torch.kernels.fb_kernels` (``fb_poly_expansion``: the
  CUDA kernel on a CUDA tensor, its plain version on a CPU tensor), or
  with ``use_kernel=False`` as six separable moments through
  :func:`tpuflow_torch.ops.filters.sep_conv2d`;
- the normal-equation field M from averaged A and the warped b difference
  with OpenCV's 5-pixel border down-weighting (:func:`update_matrices`);
- a winsize^2 box (or, with flag 0x200, Gaussian) aggregation of M's five
  channels through ``sep_conv2d`` and a per-pixel 2x2 solve; opt-in
  ``use_blur_kernel=True`` runs box + solve as one ``fb_blur_solve``;
- a pyramid of Gaussian blur (``sep_conv2d``, REFLECT101) and
  :func:`tpuflow_torch.core.resample.resize_linear`, flow upscaled by
  1/pyr_scale.

The warp is always the four-corner clamped bilinear gather
(:func:`_bilinear_all`). tpuflow's ``_warp_dense`` (dense masked shifts,
equal to the gather up to weight-rounding ulps) and ``_warp_tiled``
(per-tile pre-shift with a gather fallback) exist because the TPU's
gather unit is slow; the H100 gathers at memory speed, so neither is
ported, nor the packed (optionally bfloat16) warp table, nor the knobs
``dense_warp_d``, ``tiled_warp`` and ``warp_table_bf16``. The port
therefore equals tpuflow called with ``dense_warp_d=0`` (its gather
formula).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.core import borders as bd
from tpuflow_torch.core.resample import resize_linear
from tpuflow_torch.kernels.fb_kernels import (
    fb_blur_solve,
    fb_poly_expansion,
    solve_2x2,
)
from tpuflow_torch.ops.filters import sep_conv2d
from tpuflow_torch.utils.numerics import true_div

_BORDER = 5  # OpenCV FarnebackUpdateMatrices border band


def _poly_exp_matrices(n: int, sigma: float) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian applicability g and the 6x6 normal-equation inverse G^-1.

    Basis ordering: [1, x, y, x^2, y^2, xy] (Farneback eq. 4.6 / OpenCV
    FarnebackPrepareGaussian).
    """
    xs = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    g /= g.sum()
    X, Y = np.meshgrid(xs, xs)
    w = np.outer(g, g)
    basis = np.stack([np.ones_like(X), X, Y, X**2, Y**2, X * Y], axis=0)
    G = np.einsum("iyx,jyx,yx->ij", basis, basis, w)
    return g, np.linalg.inv(G)


def poly_taps(poly_n: int, poly_sigma: float):
    """The taps g, g*x, g*x^2 and the five G^-1 rows (the last halved: a12
    = r5/2) that ``fb_poly_expansion`` takes."""
    g, ginv = _poly_exp_matrices(poly_n, poly_sigma)
    xs = np.arange(-poly_n, poly_n + 1, dtype=np.float64)
    ginv_rows = ginv[1:6].copy()
    ginv_rows[4] *= 0.5  # the a12 = r5/2 halving
    return g, g * xs, g * xs * xs, ginv_rows


def poly_expansion(img: torch.Tensor, poly_n: int, poly_sigma: float,
                   use_kernel: bool | None = None):
    """Quadratic expansion coefficients (b1, b2, a11, a22, a12) per pixel.

    f(x + dx) ~ c + b.dx + dx^T A dx with A = [[a11, a12], [a12, a22]].
    Border: replicate (OpenCV PolyExp clamps source rows/cols).
    ``use_kernel`` None or True runs ``fb_poly_expansion`` (the kernel on
    CUDA, its plain version on the CPU); False the six separable moments.
    """
    n = poly_n
    if use_kernel is None or use_kernel:
        padded = bd.pad2d(img, n, bd.CLAMP)
        return fb_poly_expansion(padded, *poly_taps(n, poly_sigma))

    g, ginv = _poly_exp_matrices(n, poly_sigma)
    xs = np.arange(-n, n + 1, dtype=np.float64)
    gx = g * xs
    gxx = g * xs * xs

    def m(ky, kx):
        return sep_conv2d(img, kx, ky, border=bd.CLAMP)

    moments = (m(g, g), m(g, gx), m(gx, g), m(g, gxx), m(gxx, g), m(gx, gx))
    r = []
    for j in range(1, 6):
        acc = None
        for coef, mk in zip(ginv[j], moments):
            t = mk * float(coef)
            acc = t if acc is None else acc + t
        r.append(acc)
    b1, b2, a11, a22, r5 = r
    return b1, b2, a11, a22, r5 * 0.5


def bilinear(flat: torch.Tensor, pitch: int, xq: torch.Tensor,
             yq: torch.Tensor, col, row):
    """Bilinear-sample the (C, rows * pitch) stack ``flat`` at float (xq,
    yq); ``col`` and ``row`` map a corner's integer x and y to its column
    and row in the stack (where the clamping happens)."""
    x0f = torch.floor(xq)
    y0f = torch.floor(yq)
    fx = xq - x0f
    fy = yq - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    xa, xb = col(x0), col(x0 + 1)
    ya, yb = row(y0), row(y0 + 1)
    s00 = flat[:, ya * pitch + xa]
    s01 = flat[:, ya * pitch + xb]
    s10 = flat[:, yb * pitch + xa]
    s11 = flat[:, yb * pitch + xb]
    out = ((1 - fx) * (1 - fy) * s00 + fx * (1 - fy) * s01
           + (1 - fx) * fy * s10 + fx * fy * s11)
    return list(out.unbind(0))


def _bilinear_all(fields, xq: torch.Tensor, yq: torch.Tensor):
    """Bilinear-sample each (H, W) field at float (xq, yq), the four
    corners' indices clamped to the frame."""
    h, w = xq.shape
    flat = torch.stack(list(fields)).reshape(len(fields), h * w)
    return bilinear(flat, w, xq, yq, lambda x: x.clamp(0, w - 1),
                    lambda y: y.clamp(0, h - 1))


def update_matrices(R1, R2, u: torch.Tensor, v: torch.Tensor,
                    zero_flow: bool = False, origin=(0, 0), frame=None,
                    sample=None) -> torch.Tensor:
    """The 5-channel normal-equation field M (OpenCV
    FarnebackUpdateMatrices): averaged A, flow-compensated db, border
    down-weighting. ``zero_flow=True`` is the first update at a level
    whose flow is all zeros: the warp is the identity and is skipped.

    On a tile of a larger frame (``dist.farneback_sharded``), ``origin``
    is the tile's (row, column) in the frame, ``frame`` the frame's (H, W)
    and ``sample(R2, xq, yq)`` the warp at frame coordinates; the defaults
    are the whole frame and :func:`_bilinear_all`.
    """
    b1_1, b2_1, a11_1, a22_1, a12_1 = R1
    h, w = u.shape
    row0, col0 = origin
    fh, fw = (h, w) if frame is None else frame
    xs = torch.arange(col0, col0 + w, dtype=u.dtype, device=u.device)[None, :]
    ys = torch.arange(row0, row0 + h, dtype=u.dtype, device=u.device)[:, None]
    if not zero_flow:
        xq = xs + u
        yq = ys + v
        R2 = (_bilinear_all if sample is None else sample)(R2, xq, yq)
    b1_2, b2_2, a11_2, a22_2, a12_2 = R2
    a11 = (a11_1 + a11_2) * 0.5
    a12 = (a12_1 + a12_2) * 0.5
    a22 = (a22_1 + a22_2) * 0.5
    db1 = (b1_1 - b1_2) * 0.5
    db2 = (b2_1 - b2_2) * 0.5
    if not zero_flow:
        inb = (xq >= 0) & (xq < fw) & (yq >= 0) & (yq < fh)
        # OpenCV: where the warped point leaves the image, A is halved
        # (only frame-1 coefficients) and db is zeroed out of the average.
        a11 = torch.where(inb, a11, a11_1 * 0.5)
        a12 = torch.where(inb, a12, a12_1 * 0.5)
        a22 = torch.where(inb, a22, a22_1 * 0.5)
        db1 = torch.where(inb, db1, 0.0)
        db2 = torch.where(inb, db2, 0.0)
        db1 = db1 + a11 * u + a12 * v
        db2 = db2 + a12 * u + a22 * v

    # Border scale: linear ramp from the image edge over _BORDER pixels.
    dist = torch.minimum(torch.minimum(xs, fw - 1 - xs),
                         torch.minimum(ys, fh - 1 - ys))
    scale = true_div(dist + 1.0, _BORDER + 1.0).clamp(0.0, 1.0)
    a11, a12, a22 = a11 * scale, a12 * scale, a22 * scale
    db1, db2 = db1 * scale, db2 * scale

    m11 = a11 * a11 + a12 * a12
    m12 = a12 * (a11 + a22)
    m22 = a12 * a12 + a22 * a22
    h1 = a11 * db1 + a12 * db2
    h2 = a12 * db1 + a22 * db2
    return torch.stack([m11, m12, m22, h1, h2])


def _blur_same(c: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    """Separable CLAMP blur at the input size. For even kernels
    sep_conv2d pads k//2 on both sides (one extra output row/col);
    cropping the tail reproduces OpenCV's anchor-(k/2, k/2) convention
    (the streaming demo uses the even winsize 48, DenseFlow.cpp:37)."""
    h, w = c.shape
    return sep_conv2d(c, k, k, border=bd.CLAMP)[:h, :w]


def _box_blur(M: torch.Tensor, winsize: int) -> torch.Tensor:
    """Mean over winsize^2 with replicate borders (OpenCV _Blur path)."""
    k = np.full(winsize, 1.0 / winsize)
    return torch.stack([_blur_same(c, k) for c in M])


def _gaussian_blur_m(M: torch.Tensor, winsize: int) -> torch.Tensor:
    sigma = winsize * 0.3
    xs = np.arange(winsize, dtype=np.float64) - (winsize - 1) / 2.0
    k = np.exp(-(xs**2) / (2 * sigma * sigma))
    k = k / k.sum()
    return torch.stack([_blur_same(c, k) for c in M])


def _solve_flow(M: torch.Tensor):
    return solve_2x2(*M)


def _blur_solve(M: torch.Tensor, winsize: int, gaussian: bool,
                use_kernel: bool | None = None):
    """box/gaussian aggregate of the 5-channel M + 2x2 solve -> (u, v).

    ``use_kernel=True`` (box only) runs ``fb_blur_solve`` in one launch;
    the default is the separable path, as in tpuflow.
    """
    if not gaussian and use_kernel:
        m = winsize // 2
        h, w = M.shape[1], M.shape[2]
        u, v = fb_blur_solve(bd.pad2d(M, m, bd.CLAMP), winsize)
        return u[:h, :w], v[:h, :w]  # even-winsize crop (_blur_same)
    blur = _gaussian_blur_m if gaussian else _box_blur
    return _solve_flow(blur(M, winsize))


def _farneback_impl(prev, nxt, u0, v0, pyr_scale, levels, winsize,
                    iterations, poly_n, poly_sigma, gaussian,
                    use_poly_kernel=None, use_blur_kernel=None, min_level=0):
    """The coarse-to-fine loop. ``min_level > 0`` stops it early and
    returns the flow at that level's resolution: ``farneback_sharded``
    runs levels ``levels-1..1`` replicated through this loop, then tiles
    only the finest level (tpuflow's ``min_level``)."""
    h, w = prev.shape
    u = v = None
    for k in range(levels - 1, min_level - 1, -1):
        scale = pyr_scale**k
        wl = int(round(w * scale))
        hl = int(round(h * scale))
        sigma_im = (1.0 / scale - 1.0) * 0.5
        if k == 0:
            p_l, n_l = prev, nxt
        else:
            ksz = max(int(round(sigma_im * 5)) | 1, 3)
            xs = np.arange(ksz, dtype=np.float64) - ksz // 2
            g = np.exp(-(xs**2) / (2 * sigma_im**2))
            g = g / g.sum()
            p_s = sep_conv2d(prev, g, g, border=bd.REFLECT101)
            n_s = sep_conv2d(nxt, g, g, border=bd.REFLECT101)
            p_l = resize_linear(p_s, (hl, wl))
            n_l = resize_linear(n_s, (hl, wl))

        zero_flow = False
        if u is None:
            if u0 is not None:
                u = resize_linear(u0, (hl, wl)) * scale
                v = resize_linear(v0, (hl, wl)) * scale
            else:
                u = torch.zeros((hl, wl), dtype=prev.dtype, device=prev.device)
                v = torch.zeros_like(u)
                zero_flow = True
        else:
            u = true_div(resize_linear(u, (hl, wl)), pyr_scale)
            v = true_div(resize_linear(v, (hl, wl)), pyr_scale)

        R1 = poly_expansion(p_l, poly_n, poly_sigma, use_poly_kernel)
        R2 = poly_expansion(n_l, poly_n, poly_sigma, use_poly_kernel)
        M = update_matrices(R1, R2, u, v, zero_flow=zero_flow)
        for i in range(iterations):
            u, v = _blur_solve(M, winsize, gaussian, use_blur_kernel)
            if i < iterations - 1:
                M = update_matrices(R1, R2, u, v)
    return u, v


def calc_optical_flow_farneback(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    flow: tuple | None = None,
    pyr_scale: float = 0.5,
    levels: int = 3,
    winsize: int = 15,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.2,
    flags: int = 0,
    use_poly_kernel: bool | None = None,
    use_blur_kernel: bool | None = None,
):
    """OpenCV-parameterized Farneback flow of two (H, W) frames -> (u, v).

    flags bit 0x100 (OPTFLOW_USE_INITIAL_FLOW) uses ``flow`` = (u0, v0) as
    the initial flow; bit 0x200 (OPTFLOW_FARNEBACK_GAUSSIAN) switches the
    winsize aggregation to Gaussian weighting. Runs on the device and in
    the dtype of ``prev``; the kernels take float32 CUDA tensors.
    """
    use_init = bool(flags & 0x100) and flow is not None
    u0 = flow[0].to(prev.dtype) if use_init else None
    v0 = flow[1].to(prev.dtype) if use_init else None
    gaussian = bool(flags & 0x200)
    return _farneback_impl(prev, nxt.to(prev.dtype), u0, v0,
                           float(pyr_scale), levels, winsize, iterations,
                           poly_n, float(poly_sigma), gaussian,
                           use_poly_kernel, use_blur_kernel)
