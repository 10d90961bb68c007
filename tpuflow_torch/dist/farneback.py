"""Distributed Farneback dense flow: 2-D image tiling (port of
:mod:`tpuflow.dist.farneback`).

The reference runs dense Farneback through OpenCV in two production
configs, both single-level — the pair demo (0.5, 1, 64, 2, 8, 1.6)
(``FarnebackOF/FarnebackOF.cpp:24``) and the streaming config
(0.4, 1, 48, 2, 8, 1.2) (``VideoDenseOF/DenseFlow.cpp:37``). Here the
frame is tiled over a (ty, tx) mesh of ranks, as the sharded HS and IRLS
solvers tile it (:mod:`tpuflow_torch.dist.solvers`).

Every stage of single-level Farneback is window-local, so each tiles
with a bounded halo:

- polynomial expansion: ``fb_poly_expansion`` on the tile halo'd by
  poly_n (the CUDA kernel on a card, its plain version on the CPU);
- the warp gather of ``update_matrices``: the four-corner clamped
  bilinear gather of the single-device solver, served from the next
  frame's coefficients halo'd by ``warp_halo`` (default winsize) and
  exchanged once per frame; a corner beyond the halo clamps to its edge
  (exact whenever |flow| <= warp_halo);
- the winsize^2 box aggregation and the 2x2 solve: ``fb_blur_solve`` on
  the 5-channel M halo'd by winsize // 2, exchanged every iteration.

CLAMP (replicate) borders, OpenCV's convention for all three stages, are
reproduced at the frame's borders by :func:`halo_pad_2d_clamp`; interior
tile borders receive the neighbours' data. So on a 1x1 mesh the tiled
solve is :func:`tpuflow_torch.solvers.calc_optical_flow_farneback` with
``use_blur_kernel=True``, bitwise, and on larger meshes it computes the
same sums. Multi-level configs (the HS-demo comparison config,
HornSchunckOF/main.cpp:111) run the coarse levels replicated through the
single-device loop (they are small) and tile only the finest level,
warm-started with the prolonged coarse flow (the dist/pyramid.py
scheme).

Not ported: tpuflow's ``dense_warp_d`` tile warp (dense shifted slices
instead of the gather, a workaround for the TPU's slow gather; the
single-device port drops it too) and ``use_pallas`` (the device of the
tiles picks the kernel or its plain version).
"""

from __future__ import annotations

import torch

from tpuflow_torch.core.resample import resize_linear
from tpuflow_torch.dist.halo import _pad_axis, gather_tiles, tile_of
from tpuflow_torch.dist.mesh import Mesh
from tpuflow_torch.dist.solvers import _check
from tpuflow_torch.kernels.fb_kernels import fb_blur_solve, fb_poly_expansion
from tpuflow_torch.solvers.farneback import (
    _farneback_impl,
    bilinear,
    poly_taps,
    update_matrices,
)
from tpuflow_torch.utils.numerics import true_div


def halo_pad_2d_clamp(tile: torch.Tensor, r: int, mesh: Mesh) -> torch.Tensor:
    """Pad a (..., h, w) tile to (..., h + 2r, w + 2r): the neighbours'
    data across tile edges, the tile's own edge replicated where the halo
    leaves the frame. The result is the tile's window of the frame padded
    with CLAMP (x pads before y, so the frame's corners replicate the
    corner pixel, as ``core.borders.pad2d`` does)."""
    if r < 1:
        return tile
    out = _pad_axis(tile, r, mesh, "tx")
    if mesh.ix == 0:
        out[..., :, :r] = out[..., :, r:r + 1]
    if mesh.ix == mesh.tx - 1:
        out[..., :, -r:] = out[..., :, -r - 1:-r]
    out = _pad_axis(out, r, mesh, "ty")
    if mesh.iy == 0:
        out[..., :r, :] = out[..., r:r + 1, :]
    if mesh.iy == mesh.ty - 1:
        out[..., -r:, :] = out[..., -r - 1:-r, :]
    return out


def _poly_tile(tile: torch.Tensor, poly_n: int, poly_sigma: float,
               mesh: Mesh):
    """Per-tile polynomial expansion (solvers.farneback.poly_expansion on
    its kernel) with CLAMP borders from the halo exchange."""
    return fb_poly_expansion(halo_pad_2d_clamp(tile, poly_n, mesh),
                             *poly_taps(poly_n, poly_sigma))


def _blur_solve_tile(M: torch.Tensor, winsize: int, mesh: Mesh):
    """Per-tile box aggregation + 2x2 solve on the halo'd M (the
    even-winsize anchor crop of solvers.farneback._blur_solve)."""
    th, tw = M.shape[-2:]
    u, v = fb_blur_solve(halo_pad_2d_clamp(M, winsize // 2, mesh), winsize)
    return u[:th, :tw], v[:th, :tw]


def _tile_sampler(R2, wh: int, h: int, w: int, row0: int, col0: int,
                  mesh: Mesh):
    """The warp of update_matrices on a tile: the next frame's five
    coefficient fields halo'd by ``wh`` (one exchange), each corner
    clamped to the frame, then into the halo'd tile."""
    R2h = halo_pad_2d_clamp(torch.stack(R2), wh, mesh)
    rows, pitch = R2h.shape[-2:]
    flat = R2h.reshape(len(R2), rows * pitch)

    def col(x):
        return (x.clamp(0, w - 1) - (col0 - wh)).clamp(0, pitch - 1)

    def row(y):
        return (y.clamp(0, h - 1) - (row0 - wh)).clamp(0, rows - 1)

    return lambda _, xq, yq: bilinear(flat, pitch, xq, yq, col, row)


def farneback_sharded(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    mesh: Mesh,
    pyr_scale: float = 0.5,
    levels: int = 1,
    winsize: int = 15,
    iterations: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.2,
    flags: int = 0,
    warp_halo: int | None = None,
):
    """Distributed Farneback flow over a (ty, tx) mesh; returns the full
    (u, v) on every rank.

    Every rank passes the full frames on the mesh's device. Matches
    ``calc_optical_flow_farneback(flags=0, use_blur_kernel=True)``
    whenever |flow| <= warp_halo (bitwise on a 1x1 mesh). Multi-level
    configs run levels ``levels-1..1`` replicated through the
    single-device coarse-to-fine loop and tile only the finest level,
    warm-started with the prolonged coarse flow.
    """
    if flags & 0x300:
        raise ValueError("farneback_sharded: initial-flow/gaussian flags "
                         "not supported in the tiled path")
    h, w = _check(mesh, prev, nxt.to(prev.dtype))
    th, tw = h // mesh.ty, w // mesh.tx
    wh = winsize if warp_halo is None else warp_halo
    wh = min(wh, th, tw)
    m = winsize // 2
    if m > th or m > tw or poly_n > th or poly_n > tw:
        raise ValueError("tile smaller than a required halo")
    nxt = nxt.to(prev.dtype)
    row0, col0 = mesh.iy * th, mesh.ix * tw

    u = v = None
    if levels > 1:
        # The coarse levels replicated through the single-device loop
        # (min_level=1 stops before the finest level), prolonged to full
        # resolution as _farneback_impl's level-0 step does.
        uc, vc = _farneback_impl(prev, nxt, None, None, float(pyr_scale),
                                 int(levels), int(winsize), int(iterations),
                                 int(poly_n), float(poly_sigma), False,
                                 use_blur_kernel=True, min_level=1)
        u = tile_of(true_div(resize_linear(uc, (h, w)), pyr_scale), mesh)
        v = tile_of(true_div(resize_linear(vc, (h, w)), pyr_scale), mesh)

    R1 = _poly_tile(tile_of(prev, mesh), poly_n, poly_sigma, mesh)
    R2 = _poly_tile(tile_of(nxt, mesh), poly_n, poly_sigma, mesh)
    where = dict(origin=(row0, col0), frame=(h, w),
                 sample=_tile_sampler(R2, wh, h, w, row0, col0, mesh))
    zero_flow = u is None
    if zero_flow:
        u = torch.zeros((th, tw), dtype=prev.dtype, device=prev.device)
        v = torch.zeros_like(u)
    M = update_matrices(R1, R2, u, v, zero_flow=zero_flow, **where)
    for i in range(iterations):
        u, v = _blur_solve_tile(M, winsize, mesh)
        if i < iterations - 1:
            M = update_matrices(R1, R2, u, v, **where)
    return gather_tiles(u, mesh), gather_tiles(v, mesh)
