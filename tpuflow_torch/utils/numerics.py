"""Arithmetic that rounds the same on the CPU and on the card."""

from __future__ import annotations

import numpy as np
import torch


def true_div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s as a correctly rounded division on every device.

    PyTorch's CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can differ from the CPU's division in the last bit
    (unless s is a power of two). Dividing by a 0-d tensor on x's device
    keeps both devices on the IEEE division.
    """
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root on every device.

    PyTorch's vectorized CPU ``sqrt`` is not correctly rounded: about 0.6%
    of float64 (and 0.7% of float32) elements come out an ulp off, where
    the card's ``sqrt`` (and XLA's) rounds correctly. On the CPU this takes
    numpy's, which is; on the card ``torch.sqrt``.
    """
    if x.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x.detach().numpy())))
    return torch.sqrt(x)


def warm_cpu_sqrt() -> None:
    """Run one multi-threaded float64 ``torch.sqrt`` on the CPU.

    With torch 2.13 (CPU build, AVX512), the first such call in a process
    returns, about one time in 45, one thread's share of the tensor with
    ~1e-10 relative error instead of within an ulp; every later call is
    exact. Tests that hold the port's CPU path to 1e-12 call this once
    before they run.
    """
    torch.sqrt(torch.ones(1 << 16, dtype=torch.float64))


#: Elements per CPU ``pow`` call in :func:`pow_fixed_split`: below
#: PyTorch's intra-op grain size (32768), so each call runs on one thread,
#: and a multiple of every vector width, so no call but the last has a
#: scalar tail.
POW_CHUNK = 16384


def pow_fixed_split(x: torch.Tensor, p: float) -> torch.Tensor:
    """``x ** p`` whose CPU result does not depend on the thread count.

    PyTorch's vectorized CPU loops send the last few elements of each
    thread's share through the scalar routine, and ``pow``'s vector and
    scalar forms round apart in the last bit, so the result depends on how
    the work was split, and so on the thread count. Here the CPU work is
    split at fixed points instead (POW_CHUNK elements a call): the result
    is the same bits as one thread's at every count, and no process-wide
    setting changes. On the card this is ``x ** p``.
    """
    if x.device.type != "cpu" or x.numel() <= POW_CHUNK:
        return x ** p
    flat = x.contiguous().view(-1)
    return torch.cat([c ** p for c in flat.split(POW_CHUNK)]).view(x.shape)
