"""Sharded flow solvers: 2-D image tiling with halo exchange over a mesh.

Port of :mod:`tpuflow.dist.solvers` onto ``torch.distributed``. Each rank
owns one tile of a (ty, tx) :class:`~tpuflow_torch.dist.mesh.Mesh`; the
relaxation loops exchange halos with the neighbouring tiles
(:func:`~tpuflow_torch.dist.halo.halo_pad_2d`), and the global scalars
are reduced over the mesh (tpuflow's ``pmax`` is ``all_reduce(MAX)``, the
energy's ``psum`` a local float64 sum and ``all_reduce(SUM)``).

- Every function takes the full frames on every rank, as ``device_put``
  takes the global array, on the mesh's device, and returns the full
  (u, v) on every rank, gathered from the tiles.
- One-shot ops (the gradients) run on the full frame on every rank: the
  function GSPMD's auto-sharding computes in tpuflow. Each rank then
  takes its tile. The halos of fields that do not change over the sweeps
  (gradients, 1/denominator, dt) are cut from those full frames, zero
  padded, once per call: tpuflow exchanges them in every block, with the
  same values.
- ``use_pallas`` and ``interpret`` have no counterpart: a tile on the CPU
  takes the plain tile body, a tile on a card the Hopper tile kernels
  (:func:`~tpuflow_torch.kernels.hs_stencil.hs_tile_sweeps`,
  :func:`~tpuflow_torch.kernels.irls_stencil.irls_tile_sweeps`).
- Every rank takes each stop decision from the same reduced energy, so
  all ranks run the same sweeps. Each check reads it back with
  ``.item()`` (a host sync), at tpuflow's cadence and nowhere else.

Jacobi sweeps are tile-invariant given fresh halos, and a zero halo at the
frame's border is the reference's BORDER_CONSTANT / zeropad, so the
sharded solve computes the single-device sweeps cell for cell.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpuflow_torch.dist.halo import all_reduce, gather_tiles, halo_pad_2d, tile_of
from tpuflow_torch.dist.mesh import Mesh
from tpuflow_torch.kernels.fb_kernels import _box_sum_valid
from tpuflow_torch.kernels.hs_stencil import hs_tile_sweeps
from tpuflow_torch.kernels.irls_stencil import (
    NEIGHBORS,
    irls_tile_sweeps,
    neighbor_masks,
)
from tpuflow_torch.solvers.black_anandan import in_dtype, sup_of_max
from tpuflow_torch.solvers.horn_schunck import hs_gradients
from tpuflow_torch.solvers.mestimators import geman_mcclure_psi, geman_mcclure_rho


def _check(mesh: Mesh, *frames: torch.Tensor) -> tuple[int, int]:
    h, w = frames[0].shape
    if h % mesh.ty or w % mesh.tx:
        raise ValueError(f"image {h}x{w} not divisible by mesh "
                         f"{mesh.ty}x{mesh.tx}")
    for f in frames:
        if f.shape != (h, w) or f.device != mesh.device:
            raise ValueError(f"frames must be ({h}, {w}) on the mesh's device "
                             f"{mesh.device}, got {tuple(f.shape)} on "
                             f"{f.device}")
    return h, w


def _check_halo(h: int, w: int, mesh: Mesh, halo: int) -> None:
    if h // mesh.ty <= halo or w // mesh.tx <= halo:
        raise ValueError("tile smaller than the fused halo; lower fuse")


def _box_valid(padded: torch.Tensor, size: int) -> torch.Tensor:
    """Separable box *mean* of the VALID region, as shifted adds (rows
    first, then columns, in tpuflow's order)."""
    return _box_sum_valid(padded, size) * (1.0 / (size * size))


def horn_schunck_sharded(prev: torch.Tensor, next: torch.Tensor, mesh: Mesh,
                         window_size: int = 5, max_iterations: int = 100,
                         alpha: float = 1.0):
    """Sharded box-Jacobi Horn-Schunck: an r-px halo exchange of (u, v)
    every sweep and the update divided by the denominator, in plain
    PyTorch on every device (tpuflow's unfused tile body). H and W must be
    divisible by the mesh extents."""
    h, w = _check(mesh, prev, next)
    r = window_size // 2
    gx, gy, gt = (tile_of(a, mesh) for a in hs_gradients(prev, next))
    denom = alpha * alpha + gx * gx + gy * gy
    u = torch.zeros_like(gt)
    v = torch.zeros_like(gt)
    for _ in range(max_iterations):
        ubar, vbar = _box_valid(halo_pad_2d(torch.stack((u, v)), r, mesh),
                                window_size)
        upd = (gx * ubar + gy * vbar + gt) / denom
        u, v = ubar - gx * upd, vbar - gy * upd
    return gather_tiles(u, mesh), gather_tiles(v, mesh)


def horn_schunck_sharded_fused(prev: torch.Tensor, next: torch.Tensor,
                               mesh: Mesh, window_size: int = 5,
                               max_iterations: int = 100, alpha: float = 1.0,
                               fuse: int = 5):
    """Horn-Schunck with ``fuse`` sweeps per halo exchange.

    Each block exchanges a (fuse * r)-wide halo of (u, v) and runs
    ``fuse`` sweeps on the halo'd tile through
    :func:`~tpuflow_torch.kernels.hs_stencil.hs_tile_sweeps` (one launch
    on a card), with u, v zeroed outside the frame after every sweep; a
    remainder block runs the rest. The sweeps are those of the
    single-device :func:`~tpuflow_torch.solvers.horn_schunck`, cell for
    cell."""
    h, w = _check(mesh, prev, next)
    r = window_size // 2
    halo = fuse * r
    _check_halo(h, w, mesh, halo)
    gx, gy, gt = hs_gradients(prev, next)
    inv = 1.0 / (alpha * alpha + gx * gx + gy * gy)
    fixed = tile_of(torch.stack((gx, gy, gt, inv)), mesh, halo)
    th, tw = h // mesh.ty, w // mesh.tx
    u = torch.zeros((th, tw), dtype=gx.dtype, device=gx.device)
    v = torch.zeros_like(u)
    n_blocks, rem = divmod(max_iterations, fuse)
    for k in [fuse] * n_blocks + ([rem] if rem else []):
        hk = k * r
        uv = halo_pad_2d(torch.stack((u, v)), hk, mesh)
        f = fixed if k == fuse else fixed[:, halo - hk : halo - hk + th + 2 * hk,
                                          halo - hk : halo - hk + tw + 2 * hk]
        u, v = hs_tile_sweeps(uv[0], uv[1], *(a.contiguous() for a in f),
                              mesh.iy * th - hk, mesh.ix * tw - hk, h, w,
                              window_size, k)
    return gather_tiles(u, mesh), gather_tiles(v, mesh)


def horn_schunck_sharded_fused_dynamic(prev: torch.Tensor, next: torch.Tensor,
                                       mesh: Mesh, window_size: int = 5,
                                       max_iterations: int = 100,
                                       alpha: float = 1.0, fuse: int = 5):
    """:func:`horn_schunck_sharded_fused` for an iteration count that is a
    multiple of ``fuse`` (raises otherwise). In tpuflow the block count is
    a runtime operand so that one compiled program serves every budget;
    PyTorch compiles nothing, so here it is the same function."""
    _check(mesh, prev, next)
    if max_iterations % fuse:
        raise ValueError("max_iterations must be a multiple of fuse")
    return horn_schunck_sharded_fused(prev, next, mesh, window_size,
                                      max_iterations, alpha, fuse)


# ---------------------------------------------------------------------------
# Sharded Black-Anandan IRLS level


def _neighbor_terms(uv_p, u, v, sigma_s, masks, fn):
    """Sum fn(f - f_nbr) over the 4 in-frame neighbours of each cell of
    the tiles u, v; ``uv_p`` is the 1-px halo'd stack of both, ``masks``
    the in-frame masks of :data:`NEIGHBORS` from frame coordinates
    (Error_u skips missing neighbours, OpticalFlow.cpp:288-304)."""
    h, w = u.shape
    nx = torch.zeros_like(u)
    ny = torch.zeros_like(v)
    for (dx, dy), m in zip(NEIGHBORS, masks):
        un, vn = uv_p[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        nx = nx + torch.where(m, fn(u - un, sigma_s), 0.0)
        ny = ny + torch.where(m, fn(v - vn, sigma_s), 0.0)
    return nx, ny


def _sup_sharded(g_t, lambda_d, lambda_s, sigma_d, sigma_s, sup_mode, mesh):
    """Sharded sup_Error_uu: max g^2 reduced over the mesh, then the bound
    of :func:`tpuflow_torch.solvers.irls_sup` (one-element tensor on the
    tile's device)."""
    gmax = all_reduce(torch.max(g_t * g_t), mesh, dist.ReduceOp.MAX)
    return sup_of_max(gmax, lambda_d, lambda_s, sigma_d, sigma_s, sup_mode)


def _energy_sharded(u, v, gx, gy, it, lambda_d, lambda_s, sigma_d, sigma_s,
                    mesh: Mesh) -> float:
    """The robust energy of :func:`tpuflow_torch.solvers.irls_energy` over
    the mesh: each tile sums (in float64) its data terms and the neighbour
    pairs whose left or upper cell it owns, and the sums are reduced. On a
    1x1 mesh this is irls_energy's own arithmetic."""
    def total(x):
        return torch.sum(x, dtype=torch.float64)

    def rho(x):
        return geman_mcclure_rho(x, sigma_s)

    uv_p = halo_pad_2d(torch.stack((u, v)), 1, mesh) if mesh.size > 1 else None
    E = lambda_d * total(geman_mcclure_rho(gx * u + gy * v + it, sigma_d))
    for k, f in enumerate((u, v)):
        if mesh.ix < mesh.tx - 1:
            across = uv_p[k, 1:-1, 2:] - uv_p[k, 1:-1, 1:-1]
        else:
            across = f[:, 1:] - f[:, :-1]
        if mesh.iy < mesh.ty - 1:
            down = uv_p[k, 2:, 1:-1] - uv_p[k, 1:-1, 1:-1]
        else:
            down = f[1:, :] - f[:-1, :]
        E = E + 2.0 * lambda_s * (total(rho(across)) + total(rho(down)))
    return all_reduce(E, mesh, dist.ReduceOp.SUM).item()  # host sync


def irls_level_sharded(u0, v0, gx, gy, it, mesh: Mesh,
                       lambda_d: float, lambda_s: float, sigma_d: float,
                       sigma_s: float, iter_max: int,
                       error_min_threshold: float, is_level0: bool,
                       energy_every: int = 64, sup_mode: str = "reference"):
    """Sharded IRLS relaxation level (IRLS_OpticalFlow_Pyramid,
    OpticalFlow.cpp:213-270): a 1-px halo exchange every sweep; at level 0
    the energy every ``energy_every`` sweeps, above it after every sweep
    with the 3-strikes rule. sup takes the mesh-wide max, the energy the
    mesh-wide sum; every rank takes the same stop decision."""
    return _irls_level_sharded(u0, v0, gx, gy, it, mesh, lambda_d, lambda_s,
                               sigma_d, sigma_s, iter_max,
                               error_min_threshold, is_level0, energy_every,
                               sup_mode)[:2]


def _irls_level_sharded(u0, v0, gx, gy, it, mesh, lambda_d, lambda_s,
                        sigma_d, sigma_s, iter_max, error_min_threshold,
                        is_level0, energy_every=64, sup_mode="reference"):
    h, w = _check(mesh, u0, v0, gx, gy, it)
    u, v, gx, gy, it = (tile_of(a, mesh) for a in (u0, v0, gx, gy, it))
    th, tw = u.shape
    masks = neighbor_masks(mesh.iy * th, mesh.ix * tw, th, tw, h, w, u.device)
    sup_x = _sup_sharded(gx, lambda_d, lambda_s, sigma_d, sigma_s, sup_mode,
                         mesh)
    sup_y = _sup_sharded(gy, lambda_d, lambda_s, sigma_d, sigma_s, sup_mode,
                         mesh)
    threshold = in_dtype(error_min_threshold, u.dtype)
    E, inc, n = 0.0, 0, 0
    while n < iter_max:
        uv_p = halo_pad_2d(torch.stack((u, v)), 1, mesh)
        nx, ny = _neighbor_terms(uv_p, u, v, sigma_s, masks, geman_mcclure_psi)
        center = geman_mcclure_psi(gx * u + gy * v + it, sigma_d)
        u, v = (u - (lambda_d * gx * center + lambda_s * nx) / sup_x,
                v - (lambda_d * gy * center + lambda_s * ny) / sup_y)
        if not is_level0 or n % energy_every == 0:
            E_new = _energy_sharded(u, v, gx, gy, it, lambda_d, lambda_s,
                                    sigma_d, sigma_s, mesh)
        else:
            E_new = E
        if not is_level0:
            inc = inc + 1 if E_new > E else 0
        E = E_new
        n += 1
        if E < threshold or inc > 3:
            break
    return gather_tiles(u, mesh), gather_tiles(v, mesh), n


def irls_level_sharded_fused(u0, v0, gx, gy, it, mesh: Mesh,
                             lambda_d: float, lambda_s: float,
                             sigma_d: float, sigma_s: float, iter_max: int,
                             error_min_threshold: float, is_level0: bool,
                             fuse: int = 16, sup_mode: str = "reference"):
    """Sharded IRLS level with ``fuse`` sweeps per halo exchange: the
    multi-device counterpart of
    :func:`tpuflow_torch.solvers.black_anandan_fast.irls_level_fast`.

    Each block exchanges a ``fuse``-wide halo of (u, v) and runs ``fuse``
    sweeps through
    :func:`~tpuflow_torch.kernels.irls_stencil.irls_tile_sweeps` (one
    launch on a card). The energy stop test runs between blocks at the fast
    path's cadence: every 64 sweeps at level 0, every ``fuse`` above."""
    return _irls_level_sharded_fused(u0, v0, gx, gy, it, mesh, lambda_d,
                                     lambda_s, sigma_d, sigma_s, iter_max,
                                     error_min_threshold, is_level0, fuse,
                                     sup_mode)[:2]


def _irls_level_sharded_fused(u0, v0, gx, gy, it, mesh, lambda_d, lambda_s,
                              sigma_d, sigma_s, iter_max, error_min_threshold,
                              is_level0, fuse=16, sup_mode="reference"):
    h, w = _check(mesh, u0, v0, gx, gy, it)
    _check_halo(h, w, mesh, fuse)
    th, tw = h // mesh.ty, w // mesh.tx
    u, v, gx_t, gy_t, it_t = (tile_of(a, mesh) for a in (u0, v0, gx, gy, it))
    gx_p, gy_p, it_p = tile_of(torch.stack((gx, gy, it)), mesh, fuse)
    sup_x = _sup_sharded(gx_t, lambda_d, lambda_s, sigma_d, sigma_s,
                         sup_mode, mesh)
    sup_y = _sup_sharded(gy_t, lambda_d, lambda_s, sigma_d, sigma_s,
                         sup_mode, mesh)
    threshold = in_dtype(error_min_threshold, u.dtype)
    check_every = 64 if is_level0 else fuse
    blocks_per_check = max(check_every // fuse, 1)
    n_blocks = -(-iter_max // fuse)
    E, inc, b = 0.0, 0, 0
    while b < n_blocks:
        uv = halo_pad_2d(torch.stack((u, v)), fuse, mesh)
        u, v = irls_tile_sweeps(uv[0], uv[1], gx_p, gy_p, it_p, sup_x, sup_y,
                                mesh.iy * th - fuse, mesh.ix * tw - fuse, h, w,
                                fuse, lambda_d, lambda_s, sigma_d, sigma_s)
        b += 1
        if b % blocks_per_check:
            continue
        E_new = _energy_sharded(u, v, gx_t, gy_t, it_t, lambda_d, lambda_s,
                                sigma_d, sigma_s, mesh)
        if not is_level0:
            inc = inc + 1 if E_new > E else 0
        E = E_new
        if E < threshold or inc > 3:
            break
    return gather_tiles(u, mesh), gather_tiles(v, mesh), b
