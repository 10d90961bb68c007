"""L1 image filters (port of the dense-flow subset of :mod:`tpuflow.ops.filters`).

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
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.core import borders as bd
from tpuflow_torch.kernels.sepconv import sep_conv2d_valid


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
