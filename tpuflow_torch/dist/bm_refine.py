"""Distributed region-gated IRLS refinement and per-region affine fit: the
flagship's refinements over a mesh of ranks.

Port of :mod:`tpuflow.dist.bm_refine` onto ``torch.distributed``. Every
function takes the full frames on every rank (on the mesh's device), as
tpuflow's ``device_put`` takes the global array, and returns the full
result on every rank, gathered from the tiles.

- The gradients and the zero-warp dt are computed on each tile from its
  1-px halo, the mirror border re-selected at the global far edge
  (:func:`_fwd_mirror`): the operation order of the single-device
  ``gradient_method_grad`` / ``gradient_method_dt_zero``. With ``mv``
  the dt under the BM warp is computed once on the full frames (the
  floor(MV) gather crosses tiles by up to the search bound), as tpuflow
  does.
- The IRLS runs blocks of ``fuse`` region-gated sweeps on the tile halo'd
  by ``fuse`` (:func:`~tpuflow_torch.kernels.irls_stencil.irls_gated_tile_sweeps`;
  one launch on a card), exchanging the (u, v) halo once a block; the
  halos of the fixed fields (gradients, dt, labels) are exchanged once a
  call, and the label halo carries the neighbouring tiles' real labels,
  so the region gate is exact across tile edges.
- The Lipschitz sup is an all-reduce MAX; the energy a float64 sum over
  the tile and an all-reduce SUM, checked after every 64 // fuse blocks
  (sweeps 64, 128, ...: tpuflow's fused-block cadence, not the
  single-device refine's 1, 65, ...), with the 3-strikes stop and the
  E(n) trace; every rank takes the same stop decision.
- The affine fit sums each region over the tile in float64 and
  all-reduces the sums (its maxima with MAX), through the single-device
  fit's own loop (:func:`~tpuflow_torch.solvers.bm_flow._irls_affine_regions`).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from tpuflow_torch.blockmatching import matcher
from tpuflow_torch.core.color import LAB_SCALE
from tpuflow_torch.dist.halo import all_reduce, gather_tiles, halo_pad_2d, tile_of
from tpuflow_torch.dist.mesh import Mesh
from tpuflow_torch.kernels.irls_stencil import (
    NEIGHBORS,
    irls_gated_tile_sweeps,
)
from tpuflow_torch.solvers import bm_flow
from tpuflow_torch.solvers.black_anandan import in_dtype
from tpuflow_torch.solvers.mestimators import geman_mcclure_rho
from tpuflow_torch.utils.numerics import sqrt, true_div


def _check(mesh: Mesh, labels, fuse: int | None = None) -> tuple[int, int]:
    h, w = labels.shape
    if h % mesh.ty or w % mesh.tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh "
                         f"{mesh.ty}x{mesh.tx}")
    if fuse is not None and (h // mesh.ty <= fuse or w // mesh.tx <= fuse):
        raise ValueError("tile smaller than the fused halo; lower fuse")
    return h, w


def _origin(mesh: Mesh, h: int, w: int) -> tuple[int, int]:
    return mesh.iy * (h // mesh.ty), mesh.ix * (w // mesh.tx)


def _edges(mesh: Mesh, h: int, w: int, device):
    """(at_xedge, at_yedge): where the tile's pixels sit on the frame's
    last column / row."""
    th, tw = h // mesh.ty, w // mesh.tx
    row0, col0 = _origin(mesh, h, w)
    xg = torch.arange(tw, device=device)[None, :] + col0
    yg = torch.arange(th, device=device)[:, None] + row0
    return ((xg == w - 1).expand(th, tw), (yg == h - 1).expand(th, tw))


def _fwd_mirror(tile_p, dx: int, dy: int, at_xedge, at_yedge):
    """img.get_mirror(x + dx, y + dy) for dx, dy in {0, 1} on a 1-px
    halo'd tile: the +1 neighbour from the halo, the -1 neighbour at the
    global far edge (mirror: 2w - 2 - w = w - 2)."""
    th, tw = tile_p.shape[-2] - 2, tile_p.shape[-1] - 2

    def sl(ddy, ddx):
        return tile_p[..., 1 + ddy : 1 + ddy + th, 1 + ddx : 1 + ddx + tw]

    if dx and dy:
        a = torch.where(at_xedge, sl(1, -1), sl(1, 1))
        b = torch.where(at_xedge, sl(-1, -1), sl(-1, 1))
        return torch.where(at_yedge, b, a)
    if dx:
        return torch.where(at_xedge, sl(0, -1), sl(0, 1))
    if dy:
        return torch.where(at_yedge, sl(-1, 0), sl(1, 0))
    return sl(0, 0)


def _grad_tile(int_p, at_xedge, at_yedge):
    """gx, gy (2x2 forward differences of the 1-px halo'd interest tile)
    and its four taps, in gradient_method_grad's order."""
    taps = tuple(_fwd_mirror(int_p, ddx, ddy, at_xedge, at_yedge)
                 for ddx, ddy in ((0, 0), (1, 0), (0, 1), (1, 1)))
    i00, i10, i01, i11 = taps
    gx = true_div((i10 - i00) + (i11 - i01), 2.0)
    gy = true_div((i01 - i00) + (i11 - i10), 2.0)
    return gx, gy, taps


def _dt_zero_tile(ref_p, int_taps, at_xedge, at_yedge):
    """The zero-warp dt against the interest taps, in
    gradient_method_dt_zero's order."""
    i00, i10, i01, i11 = int_taps

    def at(ddx, ddy):
        return _fwd_mirror(ref_p, ddx, ddy, at_xedge, at_yedge)

    return true_div(at(0, 0) - i00 + at(1, 0) - i10
                    + at(0, 1) - i01 + at(1, 1) - i11, 4.0)


def _gated_energy_tile(u, v, lab_p, gx, gy, it, e_masks, lambda_d, lambda_s,
                       sigma_d, sigma_s, mesh: Mesh):
    """The tile's part of Error_MultipleMotion_Block, a float64 sum over
    the tile (per leading batch element): the single-device energy's
    per-site terms, the neighbours read from 1-px halos of u, v and the
    labels. The caller all-reduces it."""
    th, tw = u.shape[-2:]
    uv_p = halo_pad_2d(torch.cat([u.reshape(-1, th, tw),
                                  v.reshape(-1, th, tw)]), 1, mesh)
    nb = u.reshape(-1, th, tw).shape[0]
    u_p = uv_p[:nb].reshape(*u.shape[:-2], th + 2, tw + 2)
    v_p = uv_p[nb:].reshape(*u.shape[:-2], th + 2, tw + 2)
    lab_c = lab_p[1 : 1 + th, 1 : 1 + tw]
    norm_c = sqrt(u * u + v * v)
    E = torch.zeros_like(u)
    for (dx, dy), ok in zip(NEIGHBORS, e_masks):
        sl = (..., slice(1 + dy, 1 + dy + th), slice(1 + dx, 1 + dx + tw))
        un, vn = u_p[sl], v_p[sl]
        gate = (ok & (lab_p[sl] == lab_c)).to(u.dtype)
        prod = norm_c * sqrt(un * un + vn * vn)
        cosang = torch.where(prod > 0, (u * un + v * vn)
                             / torch.clamp_min(prod, 1e-30), 1.0)
        m = gate * (0.5 * (1.0 + cosang))
        E = E + m * (geman_mcclure_rho(u - un, sigma_s)
                     + geman_mcclure_rho(v - vn, sigma_s))
    center = geman_mcclure_rho(gx * u + gy * v + it, sigma_d)
    return torch.sum(lambda_d * center + lambda_s * E, dim=(-2, -1),
                     dtype=torch.float64)


def _refine_tiles(interest_l, refs_l, labels, mesh: Mesh, lambda_d,
                  lambda_s, sigma_d, sigma_s, iter_max: int,
                  error_min_threshold: float, fuse: int, external_dt: bool,
                  sup_mode: str, plateau_rtol: float, blocks=None):
    """The gated IRLS of B references (``refs_l`` (B, H, W): reference L
    frames, or with ``external_dt`` their precomputed dt) against one
    interest frame, on this rank's tile. Each reference keeps its own
    energy, strike count and stop; a stopped one is frozen. Returns the
    full (u, v) (B, H, W) on every rank and the trace (B, n_checks)."""
    h, w = _check(mesh, labels, fuse)
    dev = mesh.device
    dt = interest_l.dtype
    th, tw = h // mesh.ty, w // mesh.tx
    row0, col0 = _origin(mesh, h, w)
    at_xedge, at_yedge = _edges(mesh, h, w, dev)
    gx, gy, taps = _grad_tile(tile_of(interest_l, mesh, 1), at_xedge,
                              at_yedge)
    if external_dt:
        its = tile_of(refs_l, mesh)
    else:
        its = _dt_zero_tile(tile_of(refs_l, mesh, 1), taps, at_xedge,
                            at_yedge)
    batch = its.shape[0]
    maxima = all_reduce(torch.stack([torch.max(gx * gx), torch.max(gy * gy)]),
                        mesh, dist.ReduceOp.MAX)
    sup_x, sup_y = bm_flow.sup_of_max(maxima[0], maxima[1], lambda_d,
                                      lambda_s, sigma_d, sigma_s, sup_mode)
    lab_full = torch.as_tensor(labels, device=dev).to(torch.int32)
    # The fixed fields' fuse-wide halos, exchanged once.
    fixed = halo_pad_2d(torch.cat([gx[None], gy[None], its]), fuse, mesh)
    gx_p, gy_p, it_p = fixed[0], fixed[1], fixed[2:]
    lab_p = tile_of(lab_full, mesh, fuse)
    lab_1 = tile_of(lab_full, mesh, 1)
    ys = torch.arange(th, device=dev)[:, None] + row0
    xs = torch.arange(tw, device=dev)[None, :] + col0
    e_masks = [((ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0)
                & (xs + dx < w)).expand(th, tw) for dx, dy in NEIGHBORS]
    threshold = in_dtype(error_min_threshold, dt)
    consts = (lambda_d, lambda_s, sigma_d, sigma_s)

    per_check = max(64 // fuse, 1)
    n_blocks = -(-iter_max // fuse)
    n_checks = max(-(-n_blocks // per_check), 1)
    trace = [[math.nan] * n_checks for _ in range(batch)]
    u = torch.zeros((batch, th, tw), dtype=dt, device=dev)
    v = torch.zeros_like(u)
    E = [0.0] * batch
    inc = [0] * batch
    stop = [False] * batch
    launches = 0
    for b in range(n_blocks):
        if all(stop):
            break
        active = [k for k in range(batch) if not stop[k]]
        idx = torch.tensor(active, device=dev)
        n_a = len(active)
        uv_p = halo_pad_2d(torch.cat([u[idx], v[idx]]), fuse, mesh)
        ua, va = irls_gated_tile_sweeps(
            uv_p[:n_a].contiguous(), uv_p[n_a:].contiguous(), gx_p, gy_p,
            it_p[idx].contiguous(), lab_p, sup_x, sup_y, row0 - fuse,
            col0 - fuse, h, w, fuse, *consts)
        u = u.index_copy(0, idx, ua)
        v = v.index_copy(0, idx, va)
        launches += 1
        if b % per_check != per_check - 1:
            continue
        local = _gated_energy_tile(u, v, lab_1, gx, gy, its, e_masks,
                                   *consts, mesh)
        E_all = all_reduce(local, mesh, dist.ReduceOp.SUM).tolist()  # sync
        for k in active:
            E_prev, E[k] = E[k], E_all[k]
            inc[k] = inc[k] + 1 if E[k] > E_prev else 0
            trace[k][b // per_check] = E[k]
            stop[k] = (E[k] < threshold or inc[k] > 3 or (
                plateau_rtol > 0.0 and E_prev > 0
                and E[k] >= (1.0 - plateau_rtol) * E_prev))
    if blocks is not None:
        blocks.append(launches)
    return (gather_tiles(u, mesh), gather_tiles(v, mesh),
            torch.tensor(trace, dtype=dt))


def gradient_method_flow_sharded(
    reference_lab: torch.Tensor,
    interest_lab: torch.Tensor,
    labels,
    mesh: Mesh,
    lambda_d: float = bm_flow.LAMBDA_D,
    lambda_s: float = bm_flow.LAMBDA_S,
    sigma_d: float = bm_flow.SIGMA_D_BM,
    sigma_s: float = bm_flow.SIGMA_S_BM,
    iter_max: int = 2048,
    error_min_threshold: float = 1.0e-6,
    fuse: int = 8,
    mv=None,
    sup_mode: str = "reference",
    plateau_rtol: float = 0.0,
    blocks: list | None = None,
):
    """Distributed OpticalFlow_GradientMethod: returns (u, v, trace), the
    full fields on every rank.

    The single-device :func:`~tpuflow_torch.solvers.bm_flow.gradient_method_flow`'s
    descent with ``zero_warp=True`` (the flagship's MV zeroing); the stop
    decisions sit at the fused-block cadence (sweeps 64, 128, ...).
    ``labels``: the (H, W) label map, on the host or the mesh's device.
    ``mv`` (an (H, W, 2) per-pixel BM field on the mesh's device) takes
    the dt under the BM warp instead (the driver's ``refine_warp=True``).
    ``blocks``, when a list, receives the number of fused blocks run.
    """
    interest_l = interest_lab[..., 0] * LAB_SCALE
    reference_l = reference_lab[..., 0] * LAB_SCALE
    if mv is not None:
        reference_l = bm_flow.gradient_method_dt(reference_l, interest_l,
                                                 mv[..., 0], mv[..., 1])
    u, v, trace = _refine_tiles(
        interest_l, reference_l[None], labels, mesh, lambda_d, lambda_s,
        sigma_d, sigma_s, int(iter_max), error_min_threshold, int(fuse),
        mv is not None, sup_mode, float(plateau_rtol), blocks)
    return u[0], v[0], trace[0]


def gradient_method_flow_sharded_bidirectional(
    reference_labs,
    interest_lab: torch.Tensor,
    labels,
    mesh: Mesh,
    lambda_d: float = bm_flow.LAMBDA_D,
    lambda_s: float = bm_flow.LAMBDA_S,
    sigma_d: float = bm_flow.SIGMA_D_BM,
    sigma_s: float = bm_flow.SIGMA_S_BM,
    iter_max: int = 2048,
    error_min_threshold: float = 1.0e-6,
    fuse: int = 8,
    mvs=None,
    sup_mode: str = "reference",
    plateau_rtol: float = 0.0,
    blocks: list | None = None,
):
    """Both time directions of :func:`gradient_method_flow_sharded` in one
    loop: the gradient and label halos are shared, each block exchanges
    both directions' (u, v) in one message and sweeps them in one launch,
    and each direction keeps its own stop (a stopped one is frozen).
    Returns ``([(u, v), ...], trace (B, n_checks))``, each direction equal
    to its serial call."""
    interest_l = interest_lab[..., 0] * LAB_SCALE
    if mvs is None:
        refs_l = torch.stack([r[..., 0] * LAB_SCALE for r in reference_labs])
    else:
        refs_l = torch.stack([
            bm_flow.gradient_method_dt(r[..., 0] * LAB_SCALE, interest_l,
                                       mv[..., 0], mv[..., 1])
            for r, mv in zip(reference_labs, mvs)])
    u, v, trace = _refine_tiles(
        interest_l, refs_l, labels, mesh, lambda_d, lambda_s, sigma_d,
        sigma_s, int(iter_max), error_min_threshold, int(fuse),
        mvs is not None, sup_mode, float(plateau_rtol), blocks)
    return [(u[b], v[b]) for b in range(len(reference_labs))], trace


def _mirror_idx(i, n: int):
    """img.get_mirror's index fold (gradient_method_dt's)."""
    i = i.abs()
    period = 2 * n - 2 if n > 1 else 1
    i = i % period
    return torch.where(i >= n, period - i, i)


def _warp_dt_tile(int_p, ref_p, mv_u, mv_v, row0: int, col0: int, h: int,
                  w: int, R: int, at_xedge, at_yedge):
    """The 4-tap dt under the floor(MV) warp on a tile: ``ref_p`` is the
    reference tile halo'd by R (enough for |MV| + 2 and the mirror folds at
    the frame's border), ``int_p`` the interest tile halo'd by 1. The
    operation order of gradient_method_dt."""
    th, tw = mv_u.shape
    xs = torch.arange(tw, device=mv_u.device)[None, :] + col0
    ys = torch.arange(th, device=mv_u.device)[:, None] + row0
    xt = xs + torch.floor(mv_u).long()
    yt = ys + torch.floor(mv_v).long()

    def ref_at(ddx, ddy):
        ly = (_mirror_idx(yt + ddy, h) - row0 + R).clamp(0, th + 2 * R - 1)
        lx = (_mirror_idx(xt + ddx, w) - col0 + R).clamp(0, tw + 2 * R - 1)
        return ref_p[ly, lx]

    def int_at(ddx, ddy):
        return _fwd_mirror(int_p, ddx, ddy, at_xedge, at_yedge)

    return true_div(ref_at(0, 0) - int_at(0, 0)
                    + ref_at(1, 0) - int_at(1, 0)
                    + ref_at(0, 1) - int_at(0, 1)
                    + ref_at(1, 1) - int_at(1, 1), 4.0)


def affine_parametric_flow_sharded(
    reference_lab: torch.Tensor,
    interest_lab: torch.Tensor,
    mv_u: torch.Tensor,
    mv_v: torch.Tensor,
    labels,
    n_regions: int,
    mesh: Mesh,
    sigma: float = bm_flow.SIGMA_AFFINE_BM,
    iter_max: int = 256,
    error_min_threshold: float = 1.0e-6,
    normalize_steps: bool = False,
    max_displacement: int | None = None,
):
    """Distributed AffineParametric (Affine_BlockMatching.cpp:11-77): the
    per-region 6-parameter fit of the residual under the BM warp, each
    region's sums taken over the tiles and all-reduced, the parameter
    table on every rank. Returns (a (n_regions, 6), u, v), the full fields
    on every rank. ``max_displacement`` bounds |MV| for the warp halo
    (default: its observed largest, a host sync). ``labels``: the host
    (H, W) label map, or its :class:`matcher.RegionPlan` on the mesh's
    device; the tile's plan is cut from its device labels."""
    plan = matcher.as_plan(labels, n_regions, mesh.device)
    h, w = _check(mesh, plan.labels)
    if max_displacement is None:
        max_displacement = int(math.ceil(max(
            float(mv_u.abs().max()), float(mv_v.abs().max()), 0.0)))
    R = 2 * (int(max_displacement) + 2)
    if h // mesh.ty <= R or w // mesh.tx <= R:
        raise ValueError("tile smaller than the warp halo; shrink the "
                         "displacement bound or the mesh")
    interest_l = interest_lab[..., 0] * LAB_SCALE
    reference_l = reference_lab[..., 0] * LAB_SCALE
    row0, col0 = _origin(mesh, h, w)
    at_xedge, at_yedge = _edges(mesh, h, w, mesh.device)
    int_p = tile_of(interest_l, mesh, 1)
    gx, gy, _ = _grad_tile(int_p, at_xedge, at_yedge)
    it = _warp_dt_tile(int_p, tile_of(reference_l, mesh, R),
                       tile_of(mv_u, mesh), tile_of(mv_v, mesh), row0, col0,
                       h, w, R, at_xedge, at_yedge)
    tile = plan.view(slice(row0, row0 + h // mesh.ty),
                     slice(col0, col0 + w // mesh.tx))
    a, u, v = bm_flow._irls_affine_regions(
        gx, gy, it, tile, float(sigma), int(iter_max),
        error_min_threshold, normalize_steps, origin=(row0, col0),
        reduce_sum=lambda t: all_reduce(t, mesh, dist.ReduceOp.SUM),
        reduce_max=lambda t: all_reduce(t, mesh, dist.ReduceOp.MAX))
    return a, gather_tiles(u, mesh), gather_tiles(v, mesh)
