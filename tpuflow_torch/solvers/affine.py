"""Global affine parametric motion (6-parameter IRLS).

Port of :mod:`tpuflow.solvers.affine` (``Affine_MultipleMotion.cpp``):
the flow field is u = a0 + a1 x + a2 y, v = a3 + a4 x + a5 y over the
whole frame; the six coefficients are fitted coarse-to-fine by robust
gradient descent:

- sigmaD = 0.1 * sqrt(3) (Affine_MultipleMotion.cpp:18);
- pyramids + dt + two-frame summed gradients (:68);
- per level: a0, a3 *= 2 (:79-80), IterMax = 2 * max(W_l, H_l) (:81);
- update a_i -= omega / sup_i * dE_i with omega = 1e-4, the tiny-sup
  guard, and sup_i = 2 max_site (basis_i)^2 / sigmaD^2 (:121-134,
  175-222);
- dE_i = sum_site basis_i * psi_GM(g.u_a + I_t, sigmaD) (:148-172);
- stop on E < threshold.

The loop stops on a test of E, which lives on the device: each
iteration evaluates the test there and freezes (a, E, n) once it holds,
and the host reads the flag back once every :data:`STOP_CHECK_EVERY`
iterations, so the result is tpuflow's stopping iterate without a sync
per iteration. The frame sums (E and the six dE_i) are taken in float64
and cast back to the fields' dtype, so the card and the CPU sum to the
same value in their different orders.
"""

from __future__ import annotations

import math

import torch

from tpuflow_torch.core.config import MultipleMotionParam
from tpuflow_torch.pyramid import dt_pyramid, grad_pyramid, pyramider
from tpuflow_torch.solvers.mestimators import (geman_mcclure_psi,
                                               geman_mcclure_rho)
from tpuflow_torch.utils.numerics import true_div

SIGMA_D_AFFINE = 0.1 * math.sqrt(3.0)
NUM_AFFINE_PARAMETER = 6
#: Iterations between two reads of the stop flag (the loop's host syncs).
STOP_CHECK_EVERY = 64


def _coords(h: int, w: int, dtype, device):
    x = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    y = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    return x, y


def _basis(gx, gy, x, y):
    """The six gradient basis fields: [gx, gx*x, gx*y, gy, gy*x, gy*y]."""
    return torch.stack([gx, gx * x, gx * y, gy, gy * x, gy * y])


def _frame_sum(f: torch.Tensor) -> torch.Tensor:
    """Sum over the last two axes in float64, cast back to f's dtype."""
    return torch.sum(f, dim=(-2, -1), dtype=torch.float64).to(f.dtype)


def affine_flow_field(a: torch.Tensor, h: int, w: int):
    """Evaluate u = a0 + a1 x + a2 y, v = a3 + a4 x + a5 y on the grid."""
    x, y = _coords(h, w, a.dtype, a.device)
    u = a[0] + a[1] * x + a[2] * y
    v = a[3] + a[4] * x + a[5] * y
    return u, v


def affine_energy(a, gx, gy, it, sigma_d):
    h, w = gx.shape
    u, v = affine_flow_field(a, h, w)
    return _frame_sum(geman_mcclure_rho(gx * u + gy * v + it, sigma_d))


def irls_affine_level(a0, gx, gy, it, sigma_d, iter_max: int,
                      error_min_threshold: float):
    """IRLS_MultipleMotion_Affine (Affine_MultipleMotion.cpp:108-145).
    Returns (a, E, n): the parameters, the energy after the last
    iteration run (inf if none ran) and the iterations run, n as an int64
    0-d tensor."""
    h, w = gx.shape
    x, y = _coords(h, w, gx.dtype, gx.device)
    basis = _basis(gx, gy, x, y)  # (6, H, W)
    sup = true_div(2.0 * torch.amax(basis * basis, dim=(1, 2)), sigma_d**2)
    omega = torch.full((), 1.0e-4, dtype=gx.dtype, device=gx.device)
    tiny = 1.0e-16
    step = torch.where(
        sup.abs() < tiny,
        true_div(omega, tiny) * torch.sign(sup + torch.where(sup >= 0, tiny,
                                                             -tiny)),
        omega / sup)

    def residual(a):
        u = a[0] + a[1] * x + a[2] * y
        v = a[3] + a[4] * x + a[5] * y
        return gx * u + gy * v + it

    a, r = a0, residual(a0)
    E = torch.full((), math.inf, dtype=gx.dtype, device=gx.device)
    n = torch.zeros((), dtype=torch.int64, device=gx.device)
    stop = torch.zeros((), dtype=torch.bool, device=gx.device)
    for k in range(iter_max):
        if k and k % STOP_CHECK_EVERY == 0 and bool(stop):  # host sync
            break
        dE = _frame_sum(basis * geman_mcclure_psi(r, sigma_d))  # (6,)
        a_new = a - step * dE
        # The residual at a_new gives E here and psi next iteration.
        r_new = residual(a_new)
        E_new = _frame_sum(geman_mcclure_rho(r_new, sigma_d))
        a = torch.where(stop, a, a_new)
        r = torch.where(stop, r, r_new)
        E = torch.where(stop, E, E_new)
        n = n + (~stop).long()
        stop = stop | (E_new < error_min_threshold)
    return a, E, n


def multiple_motion_affine(
    it_img: torch.Tensor,
    itp1_img: torch.Tensor,
    max_int: float = 255.0,
    param: MultipleMotionParam | None = None,
) -> torch.Tensor:
    """Full coarse-to-fine affine fit; returns the 6-vector a on the
    frames' device (MultipleMotion_Affine, Affine_MultipleMotion.cpp:
    12-105)."""
    if param is None:
        param = MultipleMotionParam()
    it_n = true_div(it_img, max_int)
    itp1_n = true_div(itp1_img, max_int)
    it_levels = pyramider(it_n, param.level)
    itp1_levels = pyramider(itp1_n, param.level)
    dt_levels = dt_pyramid(it_levels, itp1_levels)
    grad_levels = grad_pyramid(it_levels, itp1_levels)  # two-frame sum

    a = it_n.new_zeros(NUM_AFFINE_PARAMETER)
    for level in range(len(it_levels) - 1, -1, -1):
        a = a.clone()
        a[0] *= 2.0
        a[3] *= 2.0
        gx, gy = grad_levels[level]
        it_l = dt_levels[level]
        iter_max = 2 * max(it_l.shape[0], it_l.shape[1])
        a, _, _ = irls_affine_level(a, gx, gy, it_l, SIGMA_D_AFFINE,
                                    iter_max, param.error_min_threshold)
    return a
