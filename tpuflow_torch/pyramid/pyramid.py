"""Gaussian pyramid, per-level derivative fields and coarse-to-fine plumbing.

Port of :mod:`tpuflow.pyramid.pyramid` (``OpticalFlow/MultiResolution.cpp``
and the coarse-to-fine helpers of ``OpticalFlow/OpticalFlow.cpp``):

- :func:`pyramider` — 5-tap separable low-pass (w = [a/2, .5, a, .5, a/2]
  / 1.8, a = 0.4), mirrored borders, x2 downsampling to ceil-sized levels;
  the strided filter is a sum of 25 strided slices (exact float32 on the
  card, no cuDNN TF32).
- :func:`grad_pyramid` — 2x2 forward-difference average gradient with the
  last-row/col clamp (MultiResolution.cpp:129-158).
- :func:`dt_pyramid` — 4-tap temporal difference (MultiResolution.cpp:197-212).
- :func:`level_down` — dt under the x2-scaled coarse flow (floor(2u)
  zero-pad gather, OpticalFlow.cpp:169-193).
- :func:`add_vector_offset` — prolongation u += 2 * u_coarse(x/2, y/2).

Pyramids are Python lists of (H_l, W_l) tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuflow_torch.core import borders as bd

_A = 0.4
_W5 = np.array([_A / 2, 0.5, _A, 0.5, _A / 2]) / (1.0 + 2 * _A)


def pyramid_sizes(width: int, height: int, max_level: int) -> list[tuple[int, int]]:
    """Per-level (width, height): ceil(size / 2**l), stopping before zero."""
    sizes = [(width, height)]
    for lev in range(1, max_level + 1):
        w = math.ceil(width * 0.5**lev)
        h = math.ceil(height * 0.5**lev)
        if w <= 0 or h <= 0:
            break
        sizes.append((w, h))
    return sizes


def _np_dtype(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def _downsample(img: torch.Tensor, out_wh: tuple[int, int]) -> torch.Tensor:
    """One pyramid level: mirrored 5x5 separable low-pass + stride 2.

    Output pixel (x, y) = sum_{m,n} w[m] w[n] mirror(img)[2y+m-2, 2x+n-2].
    """
    out_w, out_h = out_wh
    # Taps rounded as the JAX package rounds them (in the image dtype).
    w5 = _W5.astype(_np_dtype(img.dtype))
    taps = w5[:, None] * w5[None, :]
    need_h = 2 * (out_h - 1) + 3
    need_w = 2 * (out_w - 1) + 3
    pad_b = need_h - img.shape[0]
    pad_r = need_w - img.shape[1]
    p = bd.pad2d(img, (2, max(pad_b, 0), 2, max(pad_r, 0)), bd.MIRROR)
    out = None
    for m in range(5):
        for n in range(5):
            term = p[m : m + 2 * out_h - 1 : 2, n : n + 2 * out_w - 1 : 2] \
                * float(taps[m, n])
            out = term if out is None else out + term
    return out


def pyramider(img: torch.Tensor, max_level: int) -> list[torch.Tensor]:
    """Level 0 = img; level l = low-passed, x2-downsampled level l-1."""
    h, w = img.shape
    sizes = pyramid_sizes(w, h, max_level)
    levels = [img]
    for wl, hl in sizes[1:]:
        levels.append(_downsample(levels[-1], (wl, hl)))
    return levels


def _clamped_2x2_indices(h: int, w: int, device):
    """Top-left corners of the 2x2 stencils and their +1 neighbours, the
    corner clamped to size-2 (SATURATE) and the neighbour to the frame."""
    x = torch.arange(w, device=device).clamp(0, max(w - 2, 0))
    y = torch.arange(h, device=device).clamp(0, max(h - 2, 0))
    return x, (x + 1).clamp(max=w - 1), y, (y + 1).clamp(max=h - 1)


def _corners(im: torch.Tensor, idx):
    x, x1, y, y1 = idx
    rows0 = im.index_select(0, y)
    rows1 = im.index_select(0, y1)
    return (rows0.index_select(1, x), rows0.index_select(1, x1),
            rows1.index_select(1, x), rows1.index_select(1, x1))


def grad_level(img_t: torch.Tensor, img_tp1: torch.Tensor | None = None):
    """(gx, gy) 2x2 forward-difference average, clamped at the far edge."""
    idx = _clamped_2x2_indices(*img_t.shape, img_t.device)

    def g(im):
        i00, i10, i01, i11 = _corners(im, idx)
        gx = (i10 - i00 + i11 - i01) / 2.0
        gy = (i01 - i00 + i11 - i10) / 2.0
        return gx, gy

    gx, gy = g(img_t)
    if img_tp1 is not None:
        gx2, gy2 = g(img_tp1)
        gx, gy = gx + gx2, gy + gy2
    return gx, gy


def grad_pyramid(levels_t, levels_tp1=None):
    if levels_tp1 is None:
        return [grad_level(lv) for lv in levels_t]
    return [grad_level(a, b) for a, b in zip(levels_t, levels_tp1)]


def dt_level(img_t: torch.Tensor, img_tp1: torch.Tensor) -> torch.Tensor:
    d00, d10, d01, d11 = _corners(
        img_tp1 - img_t, _clamped_2x2_indices(*img_t.shape, img_t.device))
    return (d00 + d10 + d01 + d11) / 4.0


def dt_pyramid(levels_t, levels_tp1):
    return [dt_level(a, b) for a, b in zip(levels_t, levels_tp1)]


def upsample_nearest(coarse: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """coarse(x/2, y/2) lookup (integer-divide indexing, OpticalFlow.cpp:178)."""
    h, w = out_hw
    ch, cw = coarse.shape[-2], coarse.shape[-1]
    x = (torch.arange(w, device=coarse.device) // 2).clamp(0, cw - 1)
    y = (torch.arange(h, device=coarse.device) // 2).clamp(0, ch - 1)
    return coarse.index_select(-2, y).index_select(-1, x)


def level_down(
    it_level: torch.Tensor,
    itp1_level: torch.Tensor,
    u_coarse: torch.Tensor,
    v_coarse: torch.Tensor,
) -> torch.Tensor:
    """Recompute I_dt at this level under the x2-scaled coarse flow.

    dt(x,y) = mean over the 2x2 stencil of
      Itp1.zeropad(x + dx + floor(2 u_c), y + dy + floor(2 v_c))
      - It.zeropad(x + dx, y + dy)
    where (u_c, v_c) = coarse(x/2, y/2)  (OpticalFlow.cpp:176-191).
    """
    h, w = it_level.shape
    ox = torch.floor(2.0 * upsample_nearest(u_coarse, (h, w))).to(torch.int64)
    oy = torch.floor(2.0 * upsample_nearest(v_coarse, (h, w))).to(torch.int64)
    xs = torch.arange(w, device=it_level.device)[None, :]
    ys = torch.arange(h, device=it_level.device)[:, None]
    acc = torch.zeros_like(it_level)
    for dy in (0, 1):
        for dx in (0, 1):
            tp1 = bd.gather2d(itp1_level, xs + dx + ox, ys + dy + oy, bd.ZERO)
            t0 = bd.gather2d(it_level, xs + dx, ys + dy, bd.ZERO)
            acc = acc + (tp1 - t0)
    return acc / 4.0


def add_vector_offset(
    u: torch.Tensor, v: torch.Tensor, u_coarse: torch.Tensor,
    v_coarse: torch.Tensor,
):
    """Prolongation: u += 2 * u_coarse(x/2, y/2) (OpticalFlow.cpp:196-210)."""
    h, w = u.shape
    return (
        u + 2.0 * upsample_nearest(u_coarse, (h, w)),
        v + 2.0 * upsample_nearest(v_coarse, (h, w)),
    )
