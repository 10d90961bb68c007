"""Robust M-estimator penalties (rho) and influence functions (psi).

Port of :mod:`tpuflow.solvers.mestimators` (MEstimator.cpp:6-31). The
reference's Geman-McClure uses sigma, not sigma^2, in the denominator:

    rho(x, s) = x^2 / (s + x^2)
    psi(x, s) = 2 x s / (s + x^2)^2
    Lorentzian: rho = log(1 + (x/s)^2 / 2),  psi = 2x / (2 s^2 + x^2)
"""

from __future__ import annotations

import torch


def geman_mcclure_rho(x, sigma):
    return x * x / (sigma + x * x)


def geman_mcclure_psi(x, sigma):
    d = sigma + x * x
    return 2.0 * x * sigma / (d * d)


def lorentzian_rho(x, sigma):
    return torch.log1p(0.5 * (x / sigma) ** 2)


def lorentzian_psi(x, sigma):
    return 2.0 * x / (2.0 * sigma * sigma + x * x)


ESTIMATORS = {
    "geman_mcclure": (geman_mcclure_rho, geman_mcclure_psi),
    "lorentzian": (lorentzian_rho, lorentzian_psi),
}
