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


def _check_frames(mesh: Mesh, *frames) -> None:
    for f in frames:
        if f.device != mesh.device:
            raise ValueError(f"frames must be on the mesh's device "
                             f"{mesh.device}, got {f.device}")


def _match_refs_sharded(cur_lab, refs, plan: matcher.RegionPlan,
                        mesh: Mesh, search_range, coeff_mad, coeff_zncc,
                        subpixel_scale, chunk, method: str):
    """The candidate-parallel search against each of ``refs``: this
    rank's slice of the padded candidate list scored for every reference
    in one evaluator, every reference's (n_padded, n_regions) table
    gathered in candidate order, then each one's argmin and refine on
    every rank. Returns [(uv, cost)] per reference, each bitwise its
    single-device search."""
    _check_frames(mesh, cur_lab, *refs)
    matcher.validate_method(method)
    search_range = int(search_range)
    chunk = matcher.match_chunk(method, chunk)
    tables = matcher._search_tables(
        method, search_range, chunk, int(subpixel_scale), plan.n_regions,
        cur_lab.dtype, cur_lab.device, mesh.size)
    per = tables[0].shape[0] // mesh.size
    place = mesh.iy * mesh.tx + mesh.ix
    coeffs = (float(coeff_mad), float(coeff_zncc))
    local = matcher.method_costs(
        method, cur_lab, refs, plan,
        tables[0][place * per : (place + 1) * per], search_range, *coeffs,
        chunk)
    costs = [_all_gather_rows(c, mesh) for c in local]
    return [matcher._argmin_and_refine(c, cur_lab, ref, plan, tables,
                                       *coeffs, method)
            for c, ref in zip(costs, refs)]


def _match_device_sharded(cur_lab, ref_lab, plan: matcher.RegionPlan,
                          mesh: Mesh, search_range, coeff_mad, coeff_zncc,
                          subpixel_scale, chunk, method: str = "matmul"):
    """One direction's candidate-parallel search over the mesh; returns
    device tensors (uv (n_regions, 2), cost (n_regions,)) on every rank,
    bitwise :func:`~tpuflow_torch.blockmatching.matcher._match_device`'s."""
    return _match_refs_sharded(cur_lab, [ref_lab], plan, mesh, search_range,
                               coeff_mad, coeff_zncc, subpixel_scale, chunk,
                               method)[0]


def _match_device_sharded_bidirectional(cur_lab, refp_lab, refn_lab,
                                        plan: matcher.RegionPlan,
                                        mesh: Mesh, search_range, coeff_mad,
                                        coeff_zncc, subpixel_scale, chunk,
                                        method: str = "matmul"):
    """Both directions' candidate-parallel searches over one plan: the
    matmul methods score both references in one evaluator a rank and
    gather both tables. Returns ((uv_p, cost_p), (uv_n, cost_n)), each
    bitwise its single-device search."""
    return tuple(_match_refs_sharded(
        cur_lab, [refp_lab, refn_lab], plan, mesh, search_range, coeff_mad,
        coeff_zncc, subpixel_scale, chunk, method))


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
    plan = matcher.region_plan(labels, n_regions, cur_lab.device)
    uv, cost = _match_device_sharded(cur_lab, ref_lab, plan, mesh,
                                     search_range, coeff_mad, coeff_zncc,
                                     subpixel_scale, chunk, method)
    return matcher._result_from_host(uv, cost, plan.host_labels)
