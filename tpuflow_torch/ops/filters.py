"""L1 image filters (port of the dense-flow subset of :mod:`tpuflow.ops.filters`).

Filters with host-side taps are written as sums of shifted slices of the
padded image, one per nonzero tap. That keeps them exact float32 on the
card: cuDNN runs float32 convolutions in TF32 by default, which keeps
about three decimal digits. Taps are array-likes converted on the host.

- ``conv2d(..., flip=False, border="zero")`` is OpenCV ``filter2D`` as the
  HS demo uses it (correlation, BORDER_CONSTANT);
  ``flip=True`` is the reference's ``Filterer`` (a convolution).
- ``sep_conv2d`` is the plain separable correlation; its Hopper kernel
  (counterpart of ``tpuflow/kernels/sepconv.py``) comes with the slice
  that first needs it.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.core import borders as bd


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
    """Separable correlation: rows with ky then columns with kx (odd taps)."""
    kx = _taps(kx).reshape(-1)
    ky = _taps(ky).reshape(-1)
    rx, ry = kx.shape[0] // 2, ky.shape[0] // 2
    padded = bd.pad2d(img, (ry, ry, rx, rx), border)
    return _conv2d_valid(_conv2d_valid(padded, ky[:, None]), kx[None, :])


def box_filter(img: torch.Tensor, size: int, border: str = bd.ZERO) -> torch.Tensor:
    """size x size normalized box average (HS demo: size=5, BORDER_CONSTANT)."""
    return conv2d(img, np.full((size, size), 1.0 / (size * size)),
                  border=border, flip=False)
