"""Horn-Schunck dense variational optical flow (port of :mod:`tpuflow.solvers.horn_schunck`).

- :func:`horn_schunck` — parity with the reference demo
  (``HornSchunckOF/hornSchunck.cpp:19-75``): 3x3 Sobel gradients of the
  previous frame, ``gT = next - prev``, then ``max_iterations`` Jacobi
  sweeps whose neighbourhood average is a ``window_size``² box filter
  with BORDER_CONSTANT(0). The gradients are plain tensor ops; the sweeps
  run through :mod:`tpuflow_torch.kernels.hs_stencil` — the fused CUDA
  kernel on a CUDA tensor, its plain version on a CPU tensor.
- :func:`horn_schunck_classic` — the textbook 1981 formulation with the
  weighted Laplacian average; plain PyTorch on every device, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuflow_torch.core import borders as bd
from tpuflow_torch.kernels.hs_stencil import horn_schunck_fused
from tpuflow_torch.ops.derivatives import sobel_opencv
from tpuflow_torch.ops.filters import conv2d


def hs_gradients(prev: torch.Tensor, next: torch.Tensor):
    """(gX, gY, gT) per hornSchunck::getGradients (hornSchunck.cpp:19-41)."""
    gx = sobel_opencv(prev, "x")
    gy = sobel_opencv(prev, "y")
    gt = next - prev
    return gx, gy, gt


def horn_schunck(
    prev: torch.Tensor,
    next: torch.Tensor,
    window_size: int = 5,
    max_iterations: int = 100,
    alpha: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Box-average Jacobi HS, parity with hornSchunck::getFlow."""
    return horn_schunck_fused(prev, next, window_size, max_iterations, alpha)


_HS_LAPLACIAN = np.array(
    [[1 / 12, 1 / 6, 1 / 12], [1 / 6, 0.0, 1 / 6], [1 / 12, 1 / 6, 1 / 12]]
)
_KX = np.array([[-0.25, 0.25], [-0.25, 0.25]])
_KY = np.array([[-0.25, -0.25], [0.25, 0.25]])
_KT = np.full((2, 2), 0.25)


def horn_schunck_classic(
    prev: torch.Tensor,
    next: torch.Tensor,
    max_iterations: int = 100,
    alpha: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Classic Horn-Schunck 1981: weighted-Laplacian neighbourhood average,
    forward-difference gradients averaged over both frames."""
    def c(img, k):
        return conv2d(img, k, bd.CLAMP, anchor=(0, 0))

    gx = c(prev, _KX) + c(next, _KX)
    gy = c(prev, _KY) + c(next, _KY)
    gt = c(next, _KT) - c(prev, _KT)
    denom = alpha * alpha + gx * gx + gy * gy
    u = torch.zeros_like(gt)
    v = torch.zeros_like(gt)
    for _ in range(max_iterations):
        ubar = conv2d(u, _HS_LAPLACIAN, bd.CLAMP)
        vbar = conv2d(v, _HS_LAPLACIAN, bd.CLAMP)
        upd = (gx * ubar + gy * vbar + gt) / denom
        u, v = ubar - gx * upd, vbar - gy * upd
    return u, v
