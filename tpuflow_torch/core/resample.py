"""Image resampling (port of :mod:`tpuflow.core.resample`), plus the
linear resize of the Farneback pyramid.

- :func:`resize_zero_order_hold` — nearest source pixel by index scaling
  (floor), indices computed on the host in float64;
- :func:`resize_bicubic` — Keys cubic convolution (a = -0.5), clamped
  borders, as separable gathers;
- :func:`resize_linear` — ``jax.image.resize(x, shape, "linear")`` as
  tpuflow's Farneback calls it: half-pixel centres, a triangle kernel
  widened by 1/scale on downscale (anti-aliasing), weights normalized per
  output sample, samples outside [-0.5, n - 0.5] zeroed, axes whose size
  does not change skipped. The weights are built on the host in float64
  and applied as a banded sum of row/column gathers: plain elementwise
  ops, so no matrix product (which cuBLAS may run in TF32) is involved.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

ZERO_ORDER_HOLD = 0
BICUBIC = 1


def resize_zero_order_hold(img: torch.Tensor,
                           out_wh: tuple[int, int]) -> torch.Tensor:
    """(H, W[, C]) -> (oh, ow[, C]) by floor index scaling."""
    ow, oh = out_wh
    h, w = img.shape[:2]
    xs = np.clip(np.floor(np.arange(ow) * (w / ow)), 0, w - 1)
    ys = np.clip(np.floor(np.arange(oh) * (h / oh)), 0, h - 1)
    xs = torch.as_tensor(xs.astype(np.int64), device=img.device)
    ys = torch.as_tensor(ys.astype(np.int64), device=img.device)
    return img.index_select(0, ys).index_select(1, xs)


def _keys(t: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    at = t.abs()
    return torch.where(
        at <= 1.0, (a + 2.0) * at**3 - (a + 3.0) * at**2 + 1.0,
        torch.where(at < 2.0,
                    a * at**3 - 5.0 * a * at**2 + 8.0 * a * at - 4.0 * a,
                    0.0))


def resize_bicubic(img: torch.Tensor, out_wh: tuple[int, int]) -> torch.Tensor:
    """(H, W[, C]) -> (oh, ow[, C]) Keys bicubic, clamped borders; the
    result is in the image's float dtype (float32 for integer images)."""
    ow, oh = out_wh
    h, w = img.shape[:2]
    dt = img.dtype if img.is_floating_point() else torch.float32
    imgf = img.to(dt)

    def axis_resize(a, n_in, n_out, axis):
        pos = ((torch.arange(n_out, dtype=dt, device=a.device) + 0.5)
               * (n_in / n_out) - 0.5)
        i0 = torch.floor(pos).long()
        out = None
        for k in range(-1, 3):
            idx = (i0 + k).clamp(0, n_in - 1)
            wgt = _keys(pos - (i0 + k).to(dt))
            shape = [1] * a.dim()
            shape[axis] = n_out
            term = a.index_select(axis, idx) * wgt.reshape(shape)
            out = term if out is None else out + term
        return out

    return axis_resize(axis_resize(imgf, h, oh, 0), w, ow, 1)


def resample(img: torch.Tensor, out_wh: tuple[int, int],
             method: int = ZERO_ORDER_HOLD) -> torch.Tensor:
    if method == BICUBIC:
        return resize_bicubic(img, out_wh)
    return resize_zero_order_hold(img, out_wh)


@functools.lru_cache(maxsize=64)
def _linear_band(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Source indices and weights, each (B, n_out), of jax.image.resize's
    linear kernel along one axis (``compute_weight_mat``), in float64."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    band = int(np.ceil(2.0 * kernel_scale)) + 2
    idx = (np.floor(sample_f - kernel_scale).astype(np.int64)[None, :]
           + np.arange(band)[:, None])
    w = np.maximum(0.0, 1.0 - np.abs(sample_f[None, :] - idx) / kernel_scale)
    w[(idx < 0) | (idx >= n_in)] = 0.0
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    return np.clip(idx, 0, n_in - 1), w


@functools.lru_cache(maxsize=64)
def _linear_band_on(n_in: int, n_out: int, dtype: torch.dtype,
                    device: torch.device):
    idx, w = _linear_band(n_in, n_out)
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(w, device=device).to(dtype))


def _resize_axis(x: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    idx, w = _linear_band_on(x.shape[axis], n_out, x.dtype, x.device)
    shape = [1] * x.dim()
    shape[axis] = n_out
    out = None
    for b in range(idx.shape[0]):
        term = x.index_select(axis, idx[b]) * w[b].reshape(shape)
        out = term if out is None else out + term
    return out


def resize_linear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(H, W) -> out_hw, as ``jax.image.resize(img, out_hw, "linear")``."""
    for axis, n_out in enumerate(out_hw):
        if img.shape[axis] != n_out:
            img = _resize_axis(img, n_out, axis)
    return img
