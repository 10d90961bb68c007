"""Spatial derivatives (port of ``sobel_opencv`` from :mod:`tpuflow.ops.derivatives`)."""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.core import borders as bd
from tpuflow_torch.ops.filters import conv2d

_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
_SOBEL_Y = np.array([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]])


def sobel_opencv(img: torch.Tensor, axis: str) -> torch.Tensor:
    """OpenCV Sobel(ksize=3) with default BORDER_REFLECT_101."""
    k = _SOBEL_X if axis == "x" else _SOBEL_Y
    return conv2d(img, k, border=bd.REFLECT101, flip=False)
