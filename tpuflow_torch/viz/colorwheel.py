"""Middlebury-style flow color coding (port of
:mod:`tpuflow.viz.colorwheel`).

The reference only draws quivers; the colorwheel is the standard dense
visualization. Elementwise on the flow's device; numpy flows go to
``device`` first (the card unless the caller passes ``device="cpu"``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _make_colorwheel() -> np.ndarray:
    """55-entry RY/YG/GC/CB/BM/MR wheel (Baker et al., Middlebury)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = _make_colorwheel()


def flow_to_color(u, v, max_flow: float | None = None,
                  device="cuda") -> torch.Tensor:
    """(H, W) u, v -> (H, W, 3) uint8 Middlebury color coding, on u's
    device. Tensors stay on their device; numpy arrays are put on
    ``device``."""
    u, v = (x if torch.is_tensor(x)
            else torch.from_numpy(np.asarray(x)).to(device) for x in (u, v))
    rad = torch.sqrt(u * u + v * v)
    if max_flow is None:
        maxrad = torch.clamp(rad.max(), min=1e-9)
    else:
        maxrad = torch.full((), max_flow, dtype=u.dtype, device=u.device)
    un = u / maxrad
    vn = v / maxrad
    rad = torch.sqrt(un * un + vn * vn)
    wheel = torch.from_numpy(_WHEEL).to(u.device)
    ncols = wheel.shape[0]
    a = torch.atan2(-vn, -un) / math.pi  # [-1, 1]
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = torch.floor(fk).long()
    k1 = torch.remainder(k0 + 1, ncols)
    f = (fk - k0)[..., None]
    col0 = wheel[k0] / 255.0
    col1 = wheel[k1] / 255.0
    col = (1 - f) * col0 + f * col1
    radc = torch.clamp(rad, 0.0, 1.0)[..., None]
    col = 1.0 - radc * (1.0 - col)
    return (255.0 * col).to(torch.uint8)
