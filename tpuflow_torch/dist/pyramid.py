"""Sharded coarse-to-fine Black-Anandan flow.

Port of :mod:`tpuflow.dist.pyramid`. Coarse pyramid levels are tiny:
replicating them costs nothing and needs no displacement-bounded halo
analysis; only the finest levels carry real memory and compute. So:

- the pyramids, derivatives, LevelDown warp and prolongation run on the
  full frames on every rank (tpuflow lets GSPMD partition them; it
  computes the same function), through
  :func:`tpuflow_torch.solvers.black_anandan.coarse_to_fine`;
- each level's relaxation is sharded
  (:func:`~tpuflow_torch.dist.solvers.irls_level_sharded_fused` where the
  tiles fit the fused halo, else
  :func:`~tpuflow_torch.dist.solvers.irls_level_sharded` where the level
  divides over the mesh into tiles of at least 2x2), or else runs
  replicated (:func:`tpuflow_torch.solvers.irls_optical_flow_level`, the
  same on every rank);
- the iteration budget, annealing and stopping mirror
  :func:`tpuflow_torch.solvers.optical_flow_pyramid`.
"""

from __future__ import annotations

import torch

from tpuflow_torch.core.config import MultipleMotionParam
from tpuflow_torch.dist.mesh import Mesh
from tpuflow_torch.dist.solvers import (
    _irls_level_sharded,
    _irls_level_sharded_fused,
)
from tpuflow_torch.solvers.black_anandan import (
    LAMBDA_D,
    LAMBDA_S,
    coarse_to_fine,
    irls_optical_flow_level,
)


def optical_flow_pyramid_sharded(
    it_img: torch.Tensor,
    itp1_img: torch.Tensor,
    mesh: Mesh,
    max_int: float = 255.0,
    param: MultipleMotionParam | None = None,
    iter_scale: float = 1.0,
    iter_max: int = -1,
    fuse: int = 0,
    sup_mode: str = "reference",
    sweeps: list | None = None,
):
    """Multi-device Black-Anandan coarse-to-fine flow; returns the full
    (u, v) on every rank.

    ``fuse > 0`` runs ``fuse`` sweeps per halo exchange on every level
    whose tiles fit the fused halo, with the stop checks at
    :mod:`tpuflow_torch.solvers.black_anandan_fast`'s cadence; ``fuse = 0``
    exchanges a 1-px halo every sweep (the reference's stopping on every
    level). ``sweeps``, when given a list, receives the sweeps each level
    ran, coarsest level first (a fused level's blocks times ``fuse``).
    ``sup_mode``: see :func:`tpuflow_torch.solvers.irls_sup`."""
    if param is None:
        param = MultipleMotionParam()
    ty, tx = mesh.shape
    threshold = param.error_min_threshold

    def solve_level(level, u0, v0, gx, gy, it_l, sigma_d, sigma_s, iters):
        h, w = it_l.shape
        args = (u0, v0, gx, gy, it_l, mesh, LAMBDA_D, LAMBDA_S, sigma_d,
                sigma_s, iters, threshold, level == 0)
        if (fuse > 0 and h % ty == 0 and w % tx == 0
                and h // ty > fuse and w // tx > fuse):
            u, v, b = _irls_level_sharded_fused(*args, fuse=fuse,
                                                sup_mode=sup_mode)
            n = b * fuse
        elif h % ty == 0 and w % tx == 0 and h // ty >= 2 and w // tx >= 2:
            u, v, n = _irls_level_sharded(*args, sup_mode=sup_mode)
        else:  # a tiny level: the same solve on every rank
            u, v, _, n, _ = irls_optical_flow_level(
                u0, v0, gx, gy, it_l, LAMBDA_D, LAMBDA_S, sigma_d, sigma_s,
                iters, threshold, level == 0, sup_mode)
        if sweeps is not None:
            sweeps.append(n)
        return u, v

    return coarse_to_fine(it_img, itp1_img, max_int, param, iter_max,
                          iter_scale, solve_level)
