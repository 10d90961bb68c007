"""Arithmetic that rounds the same on the CPU and on the card."""

from __future__ import annotations

import torch


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as a correctly rounded division on every device.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can differ from the CPU's division in the last bit
    (unless s is a power of two). Dividing by a 0-d tensor on x's device
    keeps both devices on the IEEE division.
    """
    return x / torch.full((), s, dtype=x.dtype, device=x.device)
