"""Black-Anandan robust dense optical flow (coarse-to-fine IRLS).

Port of :mod:`tpuflow.solvers.black_anandan` (``OpticalFlow/OpticalFlow.cpp``
after M.J. Black & P. Anandan, CVIU 63(1), 1996):

- normalize both frames by MaxInt, build Gaussian pyramids
  (:mod:`tpuflow_torch.pyramid`) and per-level derivative fields;
- per level (coarse -> fine): anneal sigmaD/sigmaS linearly between
  (0.8, 0.2)/sqrt(2) and (0.3, 0.03)/sqrt(2); recompute dt under the
  x2-scaled coarse flow (LevelDown); relax; prolong (Add_VectorOffset);
- the IRLS sweep u_{n+1} = u_n - dE/sup with the Lipschitz bound
  sup = lambdaD * max|g|^2 / sigmaD^2 + 4 lambdaS / sigmaS^2;
- stopping: energy every 64 sweeps at level 0 and after every sweep
  above it, starting from E = 0; stop on E < threshold or when the
  strike counter of consecutive increases exceeds 3 (OpticalFlow.cpp:248-267).

JAX runs the level as one ``lax.while_loop``; PyTorch runs eagerly, so
here it is a Python loop. Each sweep is one call of
:func:`tpuflow_torch.kernels.irls_stencil.irls_sweeps` (one kernel launch
on CUDA). **Host syncs:** every energy check reads the energy back with
``.item()`` to take the stop decision — at exactly the JAX cadence, and
nowhere else. Energies are summed in float64, so the stop decision does
not hang on the reduction order of one device or another.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpuflow_torch.core.config import MultipleMotionParam
from tpuflow_torch.kernels.irls_stencil import NEIGHBORS, irls_sweeps
from tpuflow_torch.pyramid import (
    add_vector_offset,
    dt_pyramid,
    grad_pyramid,
    level_down,
    pyramider,
)
from tpuflow_torch.solvers.mestimators import geman_mcclure_psi, geman_mcclure_rho
from tpuflow_torch.utils.numerics import true_div
from tpuflow_torch.utils.telemetry import record_span

LAMBDA_D = 5.0
LAMBDA_S = 1.0
SIGMA_D_INIT = 0.8 / math.sqrt(2.0)
SIGMA_D_L0 = 0.2 / math.sqrt(2.0)
SIGMA_S_INIT = 0.3 / math.sqrt(2.0)
SIGMA_S_L0 = 0.03 / math.sqrt(2.0)
ENERGY_TRACE_EVERY = 64  # the reference's E(n) print cadence


def _shift_and_mask(f: torch.Tensor, dx: int, dy: int):
    """Neighbour value at (x+dx, y+dy) and a validity mask (border-excluded)."""
    h, w = f.shape
    shifted = torch.roll(f, shifts=(-dy, -dx), dims=(0, 1))
    mask = torch.ones((h, w), dtype=torch.bool, device=f.device)
    if dx == 1:
        mask[:, w - 1] = False
    elif dx == -1:
        mask[:, 0] = False
    if dy == 1:
        mask[h - 1, :] = False
    elif dy == -1:
        mask[0, :] = False
    return shifted, mask


def irls_grad(u, v, gx, gy, it, lambda_d, lambda_s, sigma_d, sigma_s):
    """(dE/du, dE/dv) at every site — Error_u (OpticalFlow.cpp:273-309)."""
    center = geman_mcclure_psi(gx * u + gy * v + it, sigma_d)
    nx = torch.zeros_like(u)
    ny = torch.zeros_like(v)
    for dx, dy in NEIGHBORS:
        un, m = _shift_and_mask(u, dx, dy)
        vn, _ = _shift_and_mask(v, dx, dy)
        nx = nx + torch.where(m, geman_mcclure_psi(u - un, sigma_s), 0.0)
        ny = ny + torch.where(m, geman_mcclure_psi(v - vn, sigma_s), 0.0)
    return (lambda_d * gx * center + lambda_s * nx,
            lambda_d * gy * center + lambda_s * ny)


def irls_energy(u, v, gx, gy, it, lambda_d, lambda_s, sigma_d, sigma_s):
    """Total robust energy — Error_MultipleMotion (OpticalFlow.cpp:335-378).

    A float64 0-d tensor on the fields' device. Each in-frame neighbour
    pair enters the reference's sum twice, once from either side, with
    the same value (rho is even), so it is summed once and doubled: one
    slice per axis instead of a rolled copy and a mask per direction."""
    def total(x):
        return torch.sum(x, dtype=torch.float64)

    E = lambda_d * total(geman_mcclure_rho(gx * u + gy * v + it, sigma_d))
    for f in (u, v):
        pairs = (total(geman_mcclure_rho(f[:, 1:] - f[:, :-1], sigma_s))
                 + total(geman_mcclure_rho(f[1:, :] - f[:-1, :], sigma_s)))
        E = E + 2.0 * lambda_s * pairs
    return E


def irls_sup(gx, gy, lambda_d, lambda_s, sigma_d, sigma_s,
             sup_mode: str = "reference"):
    """Lipschitz bound per component (sup_Error_uu, OpticalFlow.cpp:312-332),
    as 0-d tensors on the fields' device.

    ``sup_mode="reference"`` reproduces the reference's bound, which
    divides by sigma^2 although the Geman-McClure psi in use has maximum
    curvature 2/sigma — the reference's steps are ~1/(2 sigma) times
    smaller than the energy permits. ``sup_mode="analytic"`` uses the true
    bound max|psi'| = 2/sigma: the same minimizer, still monotone, ~20x
    the descent rate."""
    return tuple(sup_of_max(torch.max(g * g), lambda_d, lambda_s, sigma_d,
                            sigma_s, sup_mode) for g in (gx, gy))


def sup_of_max(gmax, lambda_d, lambda_s, sigma_d, sigma_s,
               sup_mode: str = "reference"):
    """The bound of :func:`irls_sup` from max g^2 (a 0-d tensor), which the
    sharded level reduces over the mesh first."""
    if sup_mode == "analytic":
        return (lambda_d * gmax * (2.0 / sigma_d)
                + 4.0 * lambda_s * (2.0 / sigma_s)).to(gmax.dtype)
    if sup_mode != "reference":
        raise ValueError(f"unknown sup_mode {sup_mode!r}")
    return lambda_d * gmax / sigma_d**2 + 4.0 * lambda_s / sigma_s**2


def in_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as JAX compares a Python float with an
    array of that dtype."""
    return torch.tensor(x, dtype=dtype).item()


def _trace_len(iter_max: int) -> int:
    return max(-(-iter_max // ENERGY_TRACE_EVERY), 1)


def irls_optical_flow_level(
    u0, v0, gx, gy, it,
    lambda_d, lambda_s, sigma_d, sigma_s,
    iter_max: int,
    error_min_threshold: float,
    is_level0: bool,
    sup_mode: str = "reference",
):
    """Per-level IRLS relaxation (IRLS_OpticalFlow_Pyramid), one sweep per
    kernel launch.

    Returns (u, v, E, n, trace): ``trace[k]`` is the energy after the
    sweep with ``n == 64 k`` (a CPU tensor of the fields' dtype); entries
    past the stopping point are NaN.
    """
    sup_x, sup_y = irls_sup(gx, gy, lambda_d, lambda_s, sigma_d, sigma_s,
                            sup_mode)
    threshold = in_dtype(error_min_threshold, u0.dtype)
    trace = [math.nan] * _trace_len(iter_max)
    u, v = u0, v0
    # The reference starts E at 0.0 (OpticalFlow.cpp:230): the first
    # level>0 sweep therefore always counts one (reset) strike.
    E, inc, n = 0.0, 0, 0
    while n < iter_max:
        u, v = irls_sweeps(u, v, gx, gy, it, sup_x, sup_y, 1,
                           lambda_d, lambda_s, sigma_d, sigma_s)
        if not is_level0 or (n & 0x3F) == 0:
            E_new = irls_energy(u, v, gx, gy, it, lambda_d, lambda_s,
                                sigma_d, sigma_s).item()  # host sync
        else:
            E_new = E
        if not is_level0:
            inc = inc + 1 if E_new > E else 0
        if (n & 0x3F) == 0:
            trace[n >> 6] = E_new
        E = E_new
        n += 1
        if E < threshold or inc > 3:
            break
    return u, v, E, n, torch.tensor(trace, dtype=u0.dtype)


def level_sigmas(level: int, max_level: int) -> tuple[float, float]:
    """Annealed (sigma_d, sigma_s) of a level (OpticalFlow.cpp:27-34, 113-120)."""
    if max_level == 0:
        return SIGMA_D_L0, SIGMA_S_L0
    sigma_d = SIGMA_D_INIT + (SIGMA_D_L0 - SIGMA_D_INIT) / max_level * (max_level - level)
    sigma_s = SIGMA_S_INIT + (SIGMA_S_L0 - SIGMA_S_INIT) / max_level * (max_level - level)
    return sigma_d, sigma_s


def coarse_to_fine(it_img, itp1_img, max_int, param, iter_max, iter_scale,
                   solve_level):
    """The coarse-to-fine loop both pyramids share: pyramids, annealing,
    LevelDown, per-level budget (level+1) * 10 * max(W0, H0) * iter_scale
    (capped by ``iter_max`` > 0), prolongation. ``solve_level(level, u0,
    v0, gx, gy, it_l, sigma_d, sigma_s, iters)`` relaxes one level and
    returns (u, v). Traced as the spans ``ba.pyramid`` and ``ba.level``
    (one a level; :class:`tpuflow_torch.utils.telemetry.record_span`)."""
    if param is None:
        param = MultipleMotionParam()
    dev = it_img.device
    with record_span("ba.pyramid", device=dev):
        it_levels = pyramider(true_div(it_img, max_int), param.level)
        itp1_levels = pyramider(true_div(itp1_img, max_int), param.level)
        max_level = len(it_levels) - 1  # may stop early on tiny images
        dt_levels = dt_pyramid(it_levels, itp1_levels)
        grad_levels = grad_pyramid(it_levels)

    h0, w0 = it_img.shape
    u = v = None
    for level in range(max_level, -1, -1):
        with record_span("ba.level", device=dev, level=level):
            sigma_d, sigma_s = level_sigmas(level, max_level)
            gx, gy = grad_levels[level]
            if level < max_level:
                it_l = level_down(it_levels[level], itp1_levels[level], u, v)
            else:
                it_l = dt_levels[level]
            iters = int((level + 1) * 10 * max(w0, h0) * iter_scale)
            if iter_max > 0:
                iters = min(iters, iter_max)
            u_l, v_l = solve_level(level, torch.zeros_like(it_l),
                                   torch.zeros_like(it_l), gx, gy, it_l,
                                   sigma_d, sigma_s, iters)
            if level < max_level:
                u_l, v_l = add_vector_offset(u_l, v_l, u, v)
            u, v = u_l, v_l
    return u, v


def optical_flow_pyramid(
    it_img: torch.Tensor,
    itp1_img: torch.Tensor,
    max_int: float = 255.0,
    param: MultipleMotionParam | None = None,
    iter_max: int = -1,
    iter_scale: float = 1.0,
    energy_trace=None,
    sup_mode: str = "reference",
):
    """Full coarse-to-fine Black-Anandan flow (OpticalFlow_Pyramid).

    ``iter_scale`` scales the reference's per-level iteration budget;
    ``sup_mode`` see :func:`irls_sup`; ``energy_trace`` (a
    :class:`tpuflow_torch.utils.telemetry.EnergyTrace`) collects each
    level's E(n) at the reference's 64-iteration cadence. Returns (u, v)
    at full resolution.
    """
    threshold = (param or MultipleMotionParam()).error_min_threshold

    def solve_level(level, u0, v0, gx, gy, it_l, sigma_d, sigma_s, iters):
        u, v, _, _, trace = irls_optical_flow_level(
            u0, v0, gx, gy, it_l, LAMBDA_D, LAMBDA_S, sigma_d, sigma_s,
            iters, threshold, level == 0, sup_mode)
        emit_energy_trace(level, trace, ENERGY_TRACE_EVERY, 0, energy_trace)
        return u, v

    return coarse_to_fine(it_img, itp1_img, max_int, param, iter_max,
                          iter_scale, solve_level)


def emit_energy_trace(level: int, trace, every: int, first: int,
                      energy_trace=None) -> None:
    """Push a level's E(n) trace (entry k at iteration first + k * every)
    to an EnergyTrace / the global telemetry, up to the first NaN."""
    from tpuflow_torch.utils.telemetry import EnergyTrace, get_telemetry

    if energy_trace is None and not get_telemetry().enabled:
        return
    if energy_trace is None:
        energy_trace = EnergyTrace()  # .record still emits telemetry events
    for k, e in enumerate(np.asarray(trace)):
        if np.isnan(e):
            break
        energy_trace.record(level, first + k * every, float(e))
