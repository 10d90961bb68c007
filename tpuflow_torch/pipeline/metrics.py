"""Flow-quality metrics: endpoint error (EPE) and angular error (AE)
(port of :mod:`tpuflow.pipeline.metrics`)."""

from __future__ import annotations

import torch


def epe(u, v, u_ref, v_ref, mean: bool = True):
    """Endpoint error |(u,v) - (u_ref,v_ref)| (mean over pixels by default)."""
    e = torch.sqrt((u - u_ref) ** 2 + (v - v_ref) ** 2)
    return e.mean() if mean else e


def angular_error(u, v, u_ref, v_ref, mean: bool = True):
    """Barron angular error between space-time direction vectors (u, v, 1)."""
    num = u * u_ref + v * v_ref + 1.0
    den = torch.sqrt((u**2 + v**2 + 1.0) * (u_ref**2 + v_ref**2 + 1.0))
    ae = torch.arccos(torch.clamp(num / den, -1.0, 1.0))
    return ae.mean() if mean else ae
