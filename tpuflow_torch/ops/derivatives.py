"""Spatial derivatives (port of :mod:`tpuflow.ops.derivatives`).

- ``sobel_opencv``: OpenCV-parity 3x3 Sobel (correlation,
  BORDER_REFLECT_101) as the HS demo uses it.
- ``derivator``: the reference ``Derivator`` (``lib/ImgLibrary.cpp:
  305-374``): 2x2 "Normal" difference filters or 1/4-scaled Sobel,
  through the convolution-orientation ``filterer`` (shifted slices with
  exact host taps) and zero-pad borders.
- ``derivative_angler``: the gradient orientation field in [0, 2) (units
  of pi), rotated by pi/2, with the sentinel -2*ANGLE_MAX at flat pixels
  (``lib/ImgLibrary.cpp:247-302``); it feeds the a-contrario alignment
  search. ``atan2`` is taken on the host on every device
  (``numerics.atan2``), so the card's angles are the CPU's bits and the
  alignment test decides alike.
- ``derivation_abs``: the gradient magnitude (``lib/ImgLibrary.cpp:
  377-405``), through the correctly rounded ``numerics.sqrt``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuflow_torch.core import borders as bd
from tpuflow_torch.core.config import ANGLE_MAX
from tpuflow_torch.ops.filters import conv2d, filterer
from tpuflow_torch.utils import numerics

DERIVATIVE_MINIMUM = 0.0  # Scratch_MeaningfulMotion.h:123

_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
_SOBEL_Y = np.array([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]])

# Reference Derivator kernels (ImgLibrary.cpp:314-317), conv orientation.
_DIFF_X = np.array([[-0.5, 0.5], [-0.5, 0.5]])
_DIFF_Y = np.array([[-0.5, -0.5], [0.5, 0.5]])
_SOBEL_QX = 0.25 * _SOBEL_X
_SOBEL_QY = 0.25 * _SOBEL_Y


def sobel_opencv(img: torch.Tensor, axis: str) -> torch.Tensor:
    """OpenCV Sobel(ksize=3) with default BORDER_REFLECT_101."""
    k = _SOBEL_X if axis == "x" else _SOBEL_Y
    return conv2d(img, k, border=bd.REFLECT101, flip=False)


def derivator(img: torch.Tensor, type: str = "Normal",
              mirroring: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference Derivator -> (dx, dy)."""
    if type == "Normal":
        kx, ky = _DIFF_X, _DIFF_Y
    elif type == "Sobel":
        kx, ky = _SOBEL_QX, _SOBEL_QY
    else:
        raise ValueError(f"unknown derivator type {type}")
    return filterer(img, kx, mirroring), filterer(img, ky, mirroring)


def derivation_abs(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    return numerics.sqrt(dx * dx + dy * dy)


def derivative_angler(img: torch.Tensor) -> torch.Tensor:
    """Orientation field: atan2(dy,dx)/pi + 0.5 wrapped to [0, ANGLE_MAX),
    sentinel -2*ANGLE_MAX where |dx|,|dy| <= DERIVATIVE_MINIMUM."""
    dx, dy = derivator(img, "Sobel")
    ang = numerics.true_div(numerics.atan2(dy, dx), math.pi) + 0.5
    ang = torch.where(ang > ANGLE_MAX, ang - ANGLE_MAX, ang)
    ang = torch.where(ang < 0.0, ang + ANGLE_MAX, ang)
    flat = (dx.abs() <= DERIVATIVE_MINIMUM) & (dy.abs() <= DERIVATIVE_MINIMUM)
    return torch.where(flat, torch.full((), -2.0 * ANGLE_MAX, dtype=ang.dtype,
                                        device=ang.device), ang)
