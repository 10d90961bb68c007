"""Border policies for stencil/window ops (port of :mod:`tpuflow.core.borders`).

- ``ZERO``       — out-of-range reads return 0 (ImgVector::get_zeropad,
  OpenCV BORDER_CONSTANT).
- ``MIRROR``     — symmetric reflection including the edge sample
  (ImgVector::get_mirror, numpy pad mode "symmetric").
- ``REFLECT101`` — symmetric reflection excluding the edge (OpenCV
  BORDER_REFLECT_101, numpy pad mode "reflect").
- ``CLAMP``      — coordinates saturated to the valid range (numpy "edge").

The reflecting pads are built from index arithmetic rather than
``F.pad``: ``F.pad`` has no symmetric mode, and its reflect mode refuses
pads at least as wide as the dimension, which the pyramid's coarse
levels need.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ZERO = "zero"
MIRROR = "mirror"
REFLECT101 = "reflect101"
CLAMP = "clamp"


def mirror_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Symmetric reflection including the edge, periodic with period 2n."""
    period = 2 * n
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - 1 - i, i)


def reflect101_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Symmetric reflection excluding the edge (OpenCV BORDER_REFLECT_101)."""
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i.abs(), period)
    return torch.where(i >= n, period - i, i)


def clamp_index(i: torch.Tensor, n: int) -> torch.Tensor:
    return i.clamp(0, n - 1)


_INDEX = {MIRROR: mirror_index, REFLECT101: reflect101_index,
          CLAMP: clamp_index}


def pad2d(img: torch.Tensor, pad: int | tuple[int, int, int, int],
          mode: str) -> torch.Tensor:
    """Pad the trailing two (H, W) dims by ``pad`` on each side.

    pad may be an int (same on all sides) or (top, bottom, left, right).
    """
    if isinstance(pad, int):
        pt = pb = pl_ = pr = pad
    else:
        pt, pb, pl_, pr = pad
    if mode == ZERO:
        return F.pad(img, (pl_, pr, pt, pb))
    if mode not in _INDEX:
        raise ValueError(f"unknown border mode: {mode}")
    h, w = img.shape[-2], img.shape[-1]
    index = _INDEX[mode]
    ys = index(torch.arange(-pt, h + pb, device=img.device), h)
    xs = index(torch.arange(-pl_, w + pr, device=img.device), w)
    return img.index_select(-2, ys).index_select(-1, xs)


def _take2d(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img[..., ys, xs] for in-range, broadcastable index tensors."""
    h, w = img.shape[-2], img.shape[-1]
    ys, xs = torch.broadcast_tensors(ys, xs)
    flat = img.reshape(*img.shape[:-2], h * w)
    return flat[..., ys * w + xs]


def gather2d(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
             mode: str) -> torch.Tensor:
    """Read img[y, x] (x = column, y = row) under a border policy.

    x/y are integer index tensors of any (broadcastable) shape; out-of-range
    reads resolve per ``mode``.
    """
    h, w = img.shape[-2], img.shape[-1]
    if mode == ZERO:
        valid = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        vals = _take2d(img, y.clamp(0, h - 1), x.clamp(0, w - 1))
        return torch.where(valid, vals, torch.zeros((), dtype=img.dtype,
                                                    device=img.device))
    if mode not in _INDEX:
        raise ValueError(f"unknown border mode: {mode}")
    index = _INDEX[mode]
    return _take2d(img, index(y, h), index(x, w))
