"""L1 image filters (port of :mod:`tpuflow.ops.filters`).

Filters with host-side taps are written as sums of shifted slices of the
padded image, one per nonzero tap. That keeps them exact float32 on the
card: cuDNN runs float32 convolutions in TF32 by default, which keeps
about three decimal digits. Taps are array-likes converted on the host.

- ``conv2d(..., flip=False, border="zero")`` is OpenCV ``filter2D`` as the
  HS demo uses it (correlation, BORDER_CONSTANT);
  ``flip=True`` is the reference's ``Filterer`` (a convolution).
- ``sep_conv2d`` pads for its border policy and runs the VALID separable
  correlation of :mod:`tpuflow_torch.kernels.sepconv`: on a CUDA tensor
  the hand-written kernel ``csrc/sepconv.cu`` (counterpart of
  ``tpuflow/kernels/sepconv.py``), on a CPU tensor its plain version.
  Its callers are ``gaussian_filter`` and ``box_filter`` (odd sizes),
  Lucas-Kanade's gradients and box sums, and Farneback: the pyramid blur,
  the box and Gaussian aggregation of M, and the separable moments of
  ``poly_expansion(use_kernel=False)``.
- ``gaussian_kernel``/``gaussian_filter`` are the reference's
  ``Gaussian`` (ImgLibrary.cpp:124-244); ``filterer`` its ``Filterer``.
- ``epsilon_filter`` (EpsilonFilter, ImgLibrary.cpp:58-121) and
  ``horizontal_median`` (HorizontalMedian, ImgLibrary.cpp:8-55): scratch
  detection's prefilter and median. Both are plain PyTorch on every
  device (no TPU kernel stands behind them): the epsilon filter adds its
  window's taps in tpuflow's order, rows outer and columns inner, so it
  gives tpuflow's bits at float64 and the same bits on the card as on
  the CPU; the median sorts each pixel's window.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.core import borders as bd
from tpuflow_torch.kernels.sepconv import sep_conv2d_valid
from tpuflow_torch.utils.numerics import true_div


def _taps(kernel) -> np.ndarray:
    if isinstance(kernel, torch.Tensor):
        kernel = kernel.detach().cpu().numpy()
    return np.asarray(kernel, dtype=np.float64)


def _conv2d_valid(img: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """VALID correlation of (..., H, W) img with (kh, kw) host taps."""
    kh, kw = taps.shape
    ho = img.shape[-2] - kh + 1
    wo = img.shape[-1] - kw + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            c = float(taps[i, j])
            if c == 0.0:
                continue
            term = img[..., i : i + ho, j : j + wo] * c
            out = term if out is None else out + term
    if out is None:
        return img.new_zeros((*img.shape[:-2], ho, wo))
    return out


def conv2d(
    img: torch.Tensor,
    kernel,
    border: str = bd.ZERO,
    flip: bool = False,
    anchor: tuple[int, int] | None = None,
) -> torch.Tensor:
    """2-D filtering with explicit border policy and anchor.

    flip=False -> correlation (OpenCV filter2D), flip=True -> convolution
    (the reference's Filterer). ``anchor`` is (ax, ay) in correlation
    orientation; the default is the kernel centre.
    """
    taps = _taps(kernel)
    kh, kw = taps.shape
    if flip:
        taps = taps[::-1, ::-1]
        if anchor is None:
            anchor = (kw - 1 - kw // 2, kh - 1 - kh // 2)
    if anchor is None:
        anchor = (kw // 2, kh // 2)
    ax, ay = anchor
    padded = bd.pad2d(img, (ay, kh - 1 - ay, ax, kw - 1 - ax), border)
    return _conv2d_valid(padded, taps)


def sep_conv2d(img: torch.Tensor, kx, ky, border: str = bd.ZERO) -> torch.Tensor:
    """Separable correlation of an (H, W) image: rows with ky then columns
    with kx, padded by len//2 on both sides (so even taps give one extra
    output row/column, as in tpuflow)."""
    kx = _taps(kx).reshape(-1)
    ky = _taps(ky).reshape(-1)
    rx, ry = kx.shape[0] // 2, ky.shape[0] // 2
    padded = bd.pad2d(img, (ry, ry, rx, rx), border)
    return sep_conv2d_valid(padded, ky, kx)


def box_filter(img: torch.Tensor, size: int, border: str = bd.ZERO) -> torch.Tensor:
    """size x size normalized box average (HS demo: size=5, BORDER_CONSTANT).

    Odd sizes run through :func:`sep_conv2d` with ``size`` taps of 1/size
    a side (tpuflow takes the 2-D box of 1/size^2 taps: the two differ by
    rounding only); even sizes anchor at ``size // 2`` and keep
    :func:`conv2d`, since :func:`sep_conv2d` pads ``size // 2`` on both
    sides.
    """
    if size % 2 == 1:
        taps = np.full(size, 1.0 / size)
        return sep_conv2d(img, taps, taps, border=border)
    return conv2d(img, np.full((size, size), 1.0 / (size * size)),
                  border=border, flip=False)


def filterer(img: torch.Tensor, kernel, mirroring: bool = False) -> torch.Tensor:
    """Reference ``Filterer``: convolution, zero-pad or mirror borders."""
    return conv2d(img, kernel, border=bd.MIRROR if mirroring else bd.ZERO,
                  flip=True)


def gaussian_kernel(size_wh: tuple[int, int], sigma: float,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gaussian kernel per ImgLibrary.cpp:136-210, a (kh, kw) CPU tensor.

    Even requested sizes are bumped to odd with a diamond support mask;
    normalized to sum 1. Computed in ``dtype``, as tpuflow computes it.
    """
    w, h = size_wh
    diamond = (w % 2 == 0) or (h % 2 == 0)
    if w % 2 == 0:
        w += 1
    if h % 2 == 0:
        h += 1
    w2, h2 = w // 2, h // 2
    n = torch.arange(w, dtype=dtype)[None, :]
    m = torch.arange(h, dtype=dtype)[:, None]
    g = torch.exp(-((m - h2) ** 2 + (n - w2) ** 2) / (2.0 * sigma**2))
    if diamond:
        mask = (w2 * (m - h2).abs() + h2 * (n - w2).abs()) <= w2 * h2
        g = torch.where(mask, g, 0.0)
    return g / g.sum()


def gaussian_filter(img: torch.Tensor, size_wh: tuple[int, int],
                    sigma: float) -> torch.Tensor:
    """Reference ``Gaussian``: direct convolution with zero borders.

    Odd square-or-rectangular sizes are exactly separable and run through
    :func:`sep_conv2d` with host taps (each factor normalized by its own
    sum); even sizes take the diamond kernel through :func:`conv2d`.
    """
    w, h = size_wh
    if w % 2 == 1 and h % 2 == 1:
        xs = np.arange(w, dtype=np.float64) - w // 2
        ys = np.arange(h, dtype=np.float64) - h // 2
        kx = np.exp(-(xs**2) / (2.0 * sigma**2))
        ky = np.exp(-(ys**2) / (2.0 * sigma**2))
        return sep_conv2d(img, kx / kx.sum(), ky / ky.sum(), border=bd.ZERO)
    k = gaussian_kernel(size_wh, sigma, dtype=img.dtype)
    return conv2d(img, k, border=bd.ZERO, flip=False)


def epsilon_window(center: torch.Tensor, pz: torch.Tensor, pm: torch.Tensor,
                   size_wh: tuple[int, int], epsilon: float) -> torch.Tensor:
    """The epsilon filter's window sum over (h, w) ``center`` pixels, from
    its zero-padded (``pz``) and mirror-padded (``pm``) windows, each
    padded by (h//2, w//2) on every side: a neighbour within epsilon of
    the centre adds its mirrored value, any other the centre's."""
    w, h = size_wh
    ht, wt = center.shape[-2:]
    acc = torch.zeros_like(center)
    for fy in range(h):
        for fx in range(w):
            nz = pz[..., fy : fy + ht, fx : fx + wt]
            nm = pm[..., fy : fy + ht, fx : fx + wt]
            take = (center - nz).abs() <= epsilon
            acc = acc + torch.where(take, nm, center)
    return true_div(acc, float(w * h))


def _check_epsilon_size(size_wh) -> None:
    w, h = size_wh
    if w % 2 == 0 or h % 2 == 0 or w <= 0 or h <= 0:
        raise ValueError("epsilon filter size must be odd and positive")


def epsilon_filter(img: torch.Tensor, size_wh: tuple[int, int],
                   epsilon: float) -> torch.Tensor:
    """Edge-preserving epsilon filter (ImgLibrary.cpp:100-115).

    out(x,y) = mean over window of { mirror(img)(x+f) if
    |img(x,y) - zeropad(img)(x+f)| <= eps else img(x,y) }.
    """
    _check_epsilon_size(size_wh)
    w2, h2 = size_wh[0] // 2, size_wh[1] // 2
    pad = (h2, h2, w2, w2)
    return epsilon_window(img, bd.pad2d(img, pad, bd.ZERO),
                          bd.pad2d(img, pad, bd.MIRROR), size_wh, epsilon)


def median_window(padded: torch.Tensor, x0: int, width: int,
                  full_w: int) -> torch.Tensor:
    """The horizontal median of the columns ``x0 .. x0 + wt - 1`` of a
    frame ``full_w`` wide, from rows padded by (width-1)//2 columns on the
    left and width//2 on the right: the window shrinks where it leaves the
    frame (GLOBAL columns decide), and an even count averages the two
    middle values."""
    lo = width // 2
    hi = (width - 1) // 2
    k = lo + hi + 1
    wt = padded.shape[-1] - k + 1
    cols = torch.stack([padded[..., i : i + wt] for i in range(k)], dim=-1)
    x = x0 + torch.arange(wt, device=padded.device)
    off = torch.arange(k, device=padded.device) - hi
    valid = (x[:, None] + off[None, :] >= 0) & (x[:, None] + off[None, :]
                                                 < full_w)
    cols = torch.where(valid, cols, torch.full((), float("inf"),
                                               dtype=cols.dtype,
                                               device=cols.device))
    srt = cols.sort(dim=-1).values
    count = valid.sum(dim=-1)
    mid_hi = (count // 2).expand(*srt.shape[:-1])[..., None]
    mid_lo = ((count - 1) // 2).expand(*srt.shape[:-1])[..., None]
    g_hi = srt.gather(-1, mid_hi)[..., 0]
    g_lo = srt.gather(-1, mid_lo)[..., 0]
    return 0.5 * (g_hi + g_lo)


def horizontal_median(img: torch.Tensor, width: int) -> torch.Tensor:
    """Median over a horizontal window of ``width`` pixels.

    The *intended* HorizontalMedian (ImgLibrary.cpp:8-55), as tpuflow
    implements it: interior window [x-(w-1)//2, x+w//2]; at the left
    border the window is [0, w//2], at the right border
    [x-(w-1)//2, W-1]; even-length windows average the two central order
    statistics.
    """
    lo, hi = width // 2, (width - 1) // 2
    padded = bd.pad2d(img, (0, 0, hi, lo), bd.ZERO)
    return median_window(padded, 0, width, img.shape[-1])
