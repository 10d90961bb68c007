"""Distributed block matching: search-space (candidate) parallelism.

Port of :mod:`tpuflow.dist.bm`. Regions are irregular, so the matcher
(:mod:`tpuflow_torch.blockmatching.matcher`) scores the candidate
displacements densely; the mesh splits the *candidate axis*. Every rank
holds the full frames and labels, scores an equal slice of the padded
candidate list (:func:`~tpuflow_torch.blockmatching.matcher.padded_candidates`,
(0, 0) fillers to a chunk multiple per rank), and the (n_local,
n_regions) float64 cost tables are all-gathered over the mesh's group in
global candidate order. The argmin and refinement tail then runs on every
rank. Each candidate is scored as on one device (on the CPU by the same
chunk product, on the card by the same per-candidate sums of
``csrc/bm_cost.cu``), so the result is bitwise the single-device search,
for every method; only O(n_cand x n_regions) floats cross the mesh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpuflow_torch.blockmatching import matcher
from tpuflow_torch.dist.mesh import Mesh


def _all_gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's (n_local, ...) table stacked in mesh order, on every
    rank (through the host on a staged mesh)."""
    if mesh.size == 1:
        return local
    src = local.cpu() if mesh.staged else local.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts, dim=0).to(local.device)


def _sharded_costs(mesh: Mesh, method: str, cur_lab, refs, labels_np,
                   n_regions: int, search_range: int, coeffs, chunk: int,
                   perm, bounds):
    """This rank's slice of every reference's integer cost table,
    gathered: the full padded (n_padded, n_regions) tables, one per
    reference."""
    cand_np = matcher.padded_candidates(
        matcher.method_candidates(method, search_range), chunk, mesh.size)
    per = len(cand_np) // mesh.size
    place = mesh.iy * mesh.tx + mesh.ix
    cand = torch.as_tensor(cand_np[place * per : (place + 1) * per],
                           device=cur_lab.device)
    if method == "gather":
        local = [matcher._integer_costs(cur_lab, refs[0], perm, bounds,
                                        n_regions, cand, *coeffs, chunk,
                                        search_range // 2)]
    else:
        local = matcher.method_costs(method, cur_lab, list(refs), labels_np,
                                     n_regions, cand, search_range, *coeffs,
                                     chunk)
    return [_all_gather_rows(c, mesh) for c in local]


def _check_frames(mesh: Mesh, *frames) -> None:
    for f in frames:
        if f.device != mesh.device:
            raise ValueError(f"frames must be on the mesh's device "
                             f"{mesh.device}, got {f.device}")


def _match_device_sharded(cur_lab, ref_lab, labels, n_regions: int,
                          mesh: Mesh, search_range, coeff_mad, coeff_zncc,
                          subpixel_scale, chunk, method: str = "matmul"):
    """One direction's candidate-parallel search over the mesh; returns
    device tensors (uv (n_regions, 2), cost (n_regions,)) on every rank,
    bitwise :func:`~tpuflow_torch.blockmatching.matcher._match_device`'s."""
    _check_frames(mesh, cur_lab, ref_lab)
    labels_np, labels_t, perm, bounds = matcher._plan(cur_lab, labels,
                                                      n_regions, method)
    n_regions = int(n_regions)
    search_range = int(search_range)
    chunk = matcher.match_chunk(method, chunk)
    coeffs = (float(coeff_mad), float(coeff_zncc))
    costs, = _sharded_costs(mesh, method, cur_lab, [ref_lab], labels_np,
                            n_regions, search_range, coeffs, chunk, perm,
                            bounds)
    return matcher._argmin_and_refine(costs, cur_lab, ref_lab, labels_t, perm,
                                      bounds, n_regions, search_range,
                                      int(subpixel_scale), *coeffs, method)


def _match_device_sharded_bidirectional(cur_lab, refp_lab, refn_lab, labels,
                                        n_regions: int, mesh: Mesh,
                                        search_range, coeff_mad, coeff_zncc,
                                        subpixel_scale, chunk,
                                        method: str = "matmul"):
    """Both directions' candidate-parallel searches: the matmul methods
    score both references in one evaluator a rank and gather both tables;
    ``"gather"`` runs two :func:`_match_device_sharded`. Returns ((uv_p,
    cost_p), (uv_n, cost_n)), each bitwise its single-device search."""
    if method == "gather":
        return tuple(_match_device_sharded(cur_lab, ref, labels, n_regions,
                                           mesh, search_range, coeff_mad,
                                           coeff_zncc, subpixel_scale, chunk,
                                           method)
                     for ref in (refp_lab, refn_lab))
    _check_frames(mesh, cur_lab, refp_lab, refn_lab)
    labels_np, labels_t, perm, bounds = matcher._plan(cur_lab, labels,
                                                      n_regions, method)
    n_regions = int(n_regions)
    search_range = int(search_range)
    chunk = matcher.match_chunk(method, chunk)
    coeffs = (float(coeff_mad), float(coeff_zncc))
    refs = (refp_lab, refn_lab)
    costs_pair = _sharded_costs(mesh, method, cur_lab, refs, labels_np,
                                n_regions, search_range, coeffs, chunk, perm,
                                bounds)
    return tuple(
        matcher._argmin_and_refine(costs, cur_lab, ref, labels_t, perm,
                                   bounds, n_regions, search_range,
                                   int(subpixel_scale), *coeffs, method)
        for costs, ref in zip(costs_pair, refs))


def block_matching_labels_sharded(
    cur_lab: torch.Tensor,
    ref_lab: torch.Tensor,
    labels,
    n_regions: int,
    mesh: Mesh,
    search_range: int = 61,
    coeff_mad: float = 1.0,
    coeff_zncc: float = 0.5,
    subpixel_scale: int = 2,
    chunk: int = 16,
    method: str = "matmul",
) -> matcher.BlockMatchResult:
    """Distributed :func:`~tpuflow_torch.blockmatching.block_matching_labels`:
    the same result on every rank, the search split over the mesh's ranks
    along the candidate axis. Frames on the mesh's device, labels a host
    (H, W) int map."""
    lab_np = np.asarray(labels)
    uv, cost = _match_device_sharded(cur_lab, ref_lab, lab_np, n_regions,
                                     mesh, search_range, coeff_mad,
                                     coeff_zncc, subpixel_scale, chunk,
                                     method)
    return matcher._result_from_host(uv, cost, lab_np)
