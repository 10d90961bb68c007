"""Fast Black-Anandan: the coarse-to-fine IRLS in blocks of fused sweeps.

Port of :mod:`tpuflow.solvers.black_anandan_fast`. Same math as
:func:`tpuflow_torch.solvers.black_anandan.optical_flow_pyramid` (same
pyramids, annealing, LevelDown warp, prolongation, Lipschitz steps), but
each level relaxes in blocks of ``fuse`` sweeps — one launch of the fused
IRLS kernel (:func:`tpuflow_torch.kernels.irls_stencil.irls_sweeps`) per
block on CUDA — with the energy stop test between blocks:

- level 0: energy every 64 sweeps — with ``fuse`` dividing 64 (default
  16) the cadence is the reference's (OpticalFlow.cpp:248);
- level > 0: energy and the strike counter every ``fuse`` sweeps, where
  the reference checks after every sweep. The descent is the same; only
  the stop decision is coarser.

**Host syncs:** each energy check reads the energy back with ``.item()``,
at exactly the JAX cadence; the kernel launches between checks queue
without waiting (``sup_x``/``sup_y`` stay on the device).
"""

from __future__ import annotations

import math

import torch

from tpuflow_torch.core.config import MultipleMotionParam
from tpuflow_torch.kernels.irls_stencil import irls_sweeps
from tpuflow_torch.solvers.black_anandan import (
    LAMBDA_D,
    LAMBDA_S,
    coarse_to_fine,
    emit_energy_trace,
    in_dtype,
    irls_energy,
    irls_sup,
)
from tpuflow_torch.utils.telemetry import note, record_span


def irls_level_fast(
    u0, v0, gx, gy, it,
    sigma_d: float, sigma_s: float,
    iter_max: int,
    error_min_threshold: float,
    is_level0: bool,
    fuse: int = 16,
    sup_mode: str = "reference",
):
    """One level: blocks of ``fuse`` fused sweeps + energy stop tests.

    Returns (u, v, E, blocks, trace): ``trace[k]`` is the energy at the
    k-th stop check (after ``(k+1) * check_every`` sweeps), a CPU tensor
    of the fields' dtype; NaN past the stopping point.
    """
    sup_x, sup_y = irls_sup(gx, gy, LAMBDA_D, LAMBDA_S, sigma_d, sigma_s,
                            sup_mode)
    threshold = in_dtype(error_min_threshold, u0.dtype)
    check_every = 64 if is_level0 else fuse
    blocks_per_check = max(check_every // fuse, 1)
    n_blocks = -(-iter_max // fuse)
    trace = [math.nan] * max(-(-n_blocks // blocks_per_check), 1)
    u, v = u0, v0
    E, inc, b, checks = 0.0, 0, 0, 0
    stopped = "budget"
    while b < n_blocks:
        u, v = irls_sweeps(u, v, gx, gy, it, sup_x, sup_y, fuse,
                           LAMBDA_D, LAMBDA_S, sigma_d, sigma_s)
        b += 1
        if b % blocks_per_check:
            continue
        energy = irls_energy(u, v, gx, gy, it, LAMBDA_D, LAMBDA_S,
                             sigma_d, sigma_s)
        with record_span("wait.ba_check"):
            E_new = energy.item()  # host sync
        checks += 1
        if not is_level0:
            inc = inc + 1 if E_new > E else 0
        E = E_new
        trace[b // blocks_per_check - 1] = E
        if E < threshold or inc > 3:
            stopped = "threshold" if E < threshold else "strikes"
            break
    note(blocks=b, checks=checks, stopped=stopped)
    return u, v, E, b, torch.tensor(trace, dtype=u0.dtype)


def optical_flow_pyramid_fast(
    it_img: torch.Tensor,
    itp1_img: torch.Tensor,
    max_int: float = 255.0,
    param: MultipleMotionParam | None = None,
    iter_max: int = -1,
    iter_scale: float = 1.0,
    fuse: int = 16,
    energy_trace=None,
    sup_mode: str = "reference",
    blocks: list | None = None,
):
    """Coarse-to-fine Black-Anandan flow on the fused sweep; returns (u, v).

    ``blocks``, when given a list, receives each level's block count,
    coarsest level first. ``sup_mode="analytic"``: see
    :func:`tpuflow_torch.solvers.black_anandan.irls_sup`."""
    threshold = (param or MultipleMotionParam()).error_min_threshold

    def solve_level(level, u0, v0, gx, gy, it_l, sigma_d, sigma_s, iters):
        u, v, _, b, trace = irls_level_fast(
            u0, v0, gx, gy, it_l, sigma_d, sigma_s, iters, threshold,
            level == 0, fuse, sup_mode)
        if blocks is not None:
            blocks.append(b)
        every = 64 if level == 0 else fuse
        emit_energy_trace(level, trace, every, every, energy_trace)
        return u, v

    with record_span("ba.frame"):
        return coarse_to_fine(it_img, itp1_img, max_int, param, iter_max,
                              iter_scale, solve_level)
