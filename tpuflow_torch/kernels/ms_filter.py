"""Mean-shift filtering: the CUDA kernel and its plain version.

Counterpart of ``tpuflow/kernels/ms_filter.py::mean_shift_filter_pallas``.
Every pixel is a query in joint (x, y, L, a, b) space. ``iters`` times,
each query moves to the mean of the ORIGINAL frame's points that lie
within the flat spatial kernel (radius R = ``kernel_spatial`` around the
query's current position) and the flat colour kernel (radius
``kernel_intensity`` around its current colour). The points are read at
static offsets from the query's origin pixel over the full (2E+1)^2
square, E = R + margin, in row-major offset order; the frame is padded
with a colour sentinel farther than the colour radius from every real
colour, so a point outside the frame always fails the colour test. A
query whose window empties jumps to global (0, 0), as in the reference.

:func:`mean_shift_filter` runs on a CUDA tensor through
``csrc/ms_filter.cu`` (one launch for all iterations; each query walks,
row by row, only the run of offsets that passes the spatial test, its
ends found by the exact float32 test, tests colour there, and stops at
the first iteration that gives its state back bit for bit; the source
says what bounds it on the H100 and how the design answers), on a CPU
tensor through :func:`mean_shift_filter_plain`. The form is picked by the
window alone (:func:`form_for`): the staged form while one query row's
tile of the window fits a block's shared memory (E <= 52), else the wide
form, which reads each point from device memory (the same runs, order
and exit; dx, dy and the count summed in float as the plain version sums
them).

Two optional outputs ride on the same launch (tpuflow's ``with_drift``
and ``return_trajectory``): each query's largest squared drift before a
step, which :func:`mean_shift_filter` reduces on the device to the largest
drift, and the (iters, H, W, 2) drift after each step.
:func:`mean_shift_filter_tile` runs the filter on one mesh tile halo'd by
E, the sentinel already outside the frame, at the tile's frame origin
(tpuflow's ``_ms_sharded_fn`` body); :func:`mean_shift_filter_tile_plain`
is its plain version. Its launches count in :data:`LAUNCHES_TILE`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpuflow_torch.kernels import _build
from tpuflow_torch.utils import numerics

# Launches of the CUDA kernel in this process (never the plain version):
# mean_shift_filter and mean_shift_filter_tile.
LAUNCHES = 0
LAUNCHES_TILE = 0
# A block's queries (one thread each): TILE_W columns (a warp is one row)
# by TILE_H rows, fewer where a wide window's tile would not fit one block
# (csrc/ms_filter.cu's TW, MAX_TH). The shared tile is the queries plus an
# E-pixel halo, POINT_BYTES a point (L, a, b interleaved as a float4), in
# rows of an odd pitch.
TILE_W, TILE_H = 32, 24
POINT_BYTES = 16
# The widest window the staged form's packed row sums hold (its launcher
# refuses more; shared memory already caps its E at 52).
MAX_E = 127


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from csrc/ms_filter.cu."""
    lib.ms_filter_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_float] * 2
        + [ctypes.c_void_p])
    lib.ms_filter_launch.restype = ctypes.c_int
    lib.ms_filter_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    lib.ms_filter_blocks_per_sm.restype = ctypes.c_int
    lib.ms_filter_error_string.argtypes = [ctypes.c_int]
    lib.ms_filter_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    return _bind(_build.load("ms_filter"))


def smem_bytes(E: int, tile_h: int) -> int:
    """Shared memory of one block of ``tile_h`` query rows at window E."""
    return POINT_BYTES * (tile_h + 2 * E) * ((TILE_W + 2 * E) | 1)


def form_for(E: int) -> str:
    """"staged" while one query row's tile fits a block's shared memory and
    the packed row sums hold E, else "wide" (nothing staged)."""
    return ("staged" if E <= MAX_E
            and smem_bytes(E, 1) <= _build.MAX_SMEM_BYTES else "wide")


def tile_rows(E: int) -> int:
    """The query rows of a block at window E: TILE_H, or in the staged form
    the most whose tile fits one block's shared memory."""
    th = TILE_H
    if form_for(E) == "staged":
        while smem_bytes(E, th) > _build.MAX_SMEM_BYTES:
            th -= 1
    return th


def blocks_per_sm(E: int, tile_h: int) -> int:
    """Blocks of the kernel (the form :func:`form_for` picks) one SM of the
    current card holds at once (CUDA's occupancy calculator)."""
    lib = _lib()
    n = lib.ms_filter_blocks_per_sm(E, tile_h, int(form_for(E) == "wide"))
    _build.check_launch(lib, "ms_filter", -n if n < 0 else 0)
    return n


def window(kernel_spatial: int, margin: int | None) -> int:
    """E = R + margin, the half-width of the swept offset square."""
    R = int(kernel_spatial)
    return R + (R if margin is None else int(margin))


def _filter_plain(labh, h: int, w: int, row0: int, col0: int, E: int,
                  kernel_spatial, kernel_intensity, iters: int,
                  with_drift: bool, return_trajectory: bool):
    """The kernel's function on (3, h + 2E, w + 2E) sentinel-padded planes
    whose (E, E) pixel is the query at frame coordinates (row0, col0).
    Returns (pos, color, drift2 or None, trajectory or None); drift2 is
    each query's largest squared drift before a step."""
    dt = labh.dtype
    dev = labh.device
    hs2 = float(kernel_spatial) ** 2
    hr2 = float(kernel_intensity) ** 2
    planes = labh[:, E : E + h, E : E + w]
    xs = (torch.arange(w, dtype=dt, device=dev) + col0)[None, :].expand(h, w)
    ys = (torch.arange(h, dtype=dt, device=dev) + row0)[:, None].expand(h, w)

    ex = torch.zeros((h, w), dtype=dt, device=dev)
    ey = torch.zeros_like(ex)
    drift2 = torch.zeros_like(ex) if with_drift else None
    traj = []
    c0, c1, c2 = planes[0], planes[1], planes[2]
    for _ in range(iters):
        if with_drift:
            drift2 = torch.maximum(drift2, ex * ex + ey * ey)
        s_dx, s_dy, s_n, s0, s1, s2 = (torch.zeros_like(ex) for _ in range(6))
        for dy in range(-E, E + 1):
            ty = dy - ey
            ty2 = ty * ty
            band = labh[:, E + dy : E + dy + h]
            for dx in range(-E, E + 1):
                q0, q1, q2 = band[:, :, E + dx : E + dx + w]
                tx = dx - ex
                d_sp = tx * tx + ty2
                a, b, c = q0 - c0, q1 - c1, q2 - c2
                d_cl = a * a + b * b + c * c
                wgt = ((d_sp <= hs2) & (d_cl <= hr2)).to(dt)
                s_dx = s_dx + wgt * dx
                s_dy = s_dy + wgt * dy
                s_n = s_n + wgt
                s0 = s0 + wgt * q0
                s1 = s1 + wgt * q1
                s2 = s2 + wgt * q2
        n = torch.clamp_min(s_n, 1.0)
        got = s_n > 0
        ex = torch.where(got, s_dx / n, -xs)
        ey = torch.where(got, s_dy / n, -ys)
        c0, c1, c2 = s0 / n, s1 / n, s2 / n
        if return_trajectory:
            traj.append(torch.stack([ex, ey], dim=-1))
    return (torch.stack([xs + ex, ys + ey], dim=-1),
            torch.stack([c0, c1, c2], dim=-1), drift2,
            torch.stack(traj) if return_trajectory else None)


def _extras(pos, col, drift2, traj, with_drift, return_trajectory):
    """(pos, col[, largest drift][, trajectory]) as tpuflow returns them:
    the largest drift is the root of the largest drift2, a 0-d tensor on
    the device (the root is monotone, so this is the largest root)."""
    out = (pos, col)
    if with_drift:
        out += (numerics.sqrt(drift2.max()),)
    if return_trajectory:
        out += (traj,)
    return out


def _padded_planes(lab: torch.Tensor, E: int, sentinel) -> torch.Tensor:
    h, w = lab.shape[:2]
    labh = sentinel.expand(3, h + 2 * E, w + 2 * E).clone()
    labh[:, E : E + h, E : E + w] = lab.permute(2, 0, 1)
    return labh


def mean_shift_filter_plain(lab: torch.Tensor, kernel_spatial: int = 20,
                            kernel_intensity: float = 16.0 / 255.0,
                            iters: int = 8, margin: int | None = None,
                            with_drift: bool = False,
                            return_trajectory: bool = False):
    """The kernel's function in plain PyTorch; returns (pos (H, W, 2) xy,
    color (H, W, 3)), then the largest drift (``with_drift``) and the
    (iters, H, W, 2) drift after each step (``return_trajectory``). One
    pass of ~25 elementwise ops per offset."""
    from tpuflow_torch.segmentation.meanshift import _color_sentinel

    h, w = lab.shape[:2]
    E = window(kernel_spatial, margin)
    labh = _padded_planes(lab, E, _color_sentinel(lab, kernel_intensity))
    return _extras(*_filter_plain(labh, h, w, 0, 0, E, kernel_spatial,
                                  kernel_intensity, iters, with_drift,
                                  return_trajectory),
                   with_drift, return_trajectory)


def _check_lab(name, lab):
    if lab.dim() != 3 or lab.shape[-1] != 3:
        raise ValueError(f"{name}: need (H, W, 3) Lab, got "
                         f"{tuple(lab.shape)}")
    if lab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {lab.device}")
    if lab.device.type == "cuda" and (lab.dtype != torch.float32
                                      or not lab.is_contiguous()):
        raise TypeError(f"{name}: the CUDA kernel takes contiguous float32, "
                        f"got {lab.dtype}")


def _launch(lab, sentinel, h, w, off, row0, col0, E, kernel_spatial,
            kernel_intensity, iters, with_drift, return_trajectory):
    """One launch of the form :func:`form_for` picks on ``lab``, the input
    plane (see csrc/ms_filter.cu); returns (pos, col, drift2, traj)."""
    th = tile_rows(E)
    lib = _lib()
    dev = lab.device
    pos = torch.empty((h, w, 2), dtype=lab.dtype, device=dev)
    col = torch.empty((h, w, 3), dtype=lab.dtype, device=dev)
    drift2 = (torch.empty((h, w), dtype=lab.dtype, device=dev)
              if with_drift else None)
    traj = (torch.empty((iters, h, w, 2), dtype=lab.dtype, device=dev)
            if return_trajectory else None)
    with torch.cuda.device(dev):
        rc = lib.ms_filter_launch(
            lab.data_ptr(), sentinel.data_ptr(), pos.data_ptr(),
            col.data_ptr(), 0 if drift2 is None else drift2.data_ptr(),
            0 if traj is None else traj.data_ptr(), lab.shape[0],
            lab.shape[1], h, w, off, int(row0), int(col0), E,
            math.ceil(kernel_spatial), int(iters), th,
            int(form_for(E) == "wide"), float(kernel_spatial) ** 2,
            float(kernel_intensity) ** 2,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "ms_filter", rc)
    return pos, col, drift2, traj


def mean_shift_filter(lab: torch.Tensor, kernel_spatial: int = 20,
                      kernel_intensity: float = 16.0 / 255.0,
                      iters: int = 8, margin: int | None = None,
                      with_drift: bool = False,
                      return_trajectory: bool = False):
    """``iters`` mean-shift steps; returns (pos (H, W, 2) xy, color (H, W,
    3)), then the largest drift of a query before any step (a 0-d tensor,
    ``with_drift``) and the (iters, H, W, 2) drift after each step
    (``return_trajectory``), as tpuflow's filter returns them.

    CPU tensors take :func:`mean_shift_filter_plain`; a CUDA tensor
    (contiguous float32 (H, W, 3)) takes one launch of the CUDA kernel in
    the form :func:`form_for` picks, the extra outputs included, or raises.
    """
    global LAUNCHES
    _check_lab("mean_shift_filter", lab)
    if lab.device.type == "cpu":
        return mean_shift_filter_plain(lab, kernel_spatial, kernel_intensity,
                                       iters, margin, with_drift,
                                       return_trajectory)
    from tpuflow_torch.segmentation.meanshift import _color_sentinel

    E = window(kernel_spatial, margin)
    h, w = lab.shape[:2]
    out = _launch(lab, _color_sentinel(lab, kernel_intensity), h, w, 0, 0, 0,
                  E, kernel_spatial, kernel_intensity, iters, with_drift,
                  return_trajectory)
    LAUNCHES += 1
    return _extras(*out, with_drift, return_trajectory)


def mean_shift_filter_tile_plain(lab_p: torch.Tensor, row0: int, col0: int,
                                 E: int, kernel_spatial: int = 20,
                                 kernel_intensity: float = 16.0 / 255.0,
                                 iters: int = 8):
    """:func:`mean_shift_filter_tile` in plain PyTorch."""
    th, tw = lab_p.shape[0] - 2 * E, lab_p.shape[1] - 2 * E
    pos, col, _, _ = _filter_plain(lab_p.permute(2, 0, 1), th, tw, row0,
                                   col0, E, kernel_spatial, kernel_intensity,
                                   iters, False, False)
    return pos, col


def mean_shift_filter_tile(lab_p: torch.Tensor, row0: int, col0: int,
                           E: int, kernel_spatial: int = 20,
                           kernel_intensity: float = 16.0 / 255.0,
                           iters: int = 8):
    """``iters`` mean-shift steps for the (th, tw) core of one mesh tile.

    ``lab_p`` is the (th + 2E, tw + 2E, 3) Lab tile halo'd by the window E
    (the neighbouring tiles' pixels, and the colour sentinel outside the
    frame); (row0, col0) are the frame coordinates of the core's (0, 0).
    Returns the core's global positions (th, tw, 2) and colours (th, tw,
    3). A window of E never reads outside the tile, so the launcher's
    sentinel (the value of a read outside its input plane) is never used:
    the tile's first element stands in for it. CPU tensors take
    :func:`mean_shift_filter_tile_plain`; a CUDA tensor (contiguous
    float32) one launch of the CUDA kernel, or raises.
    """
    global LAUNCHES_TILE
    _check_lab("mean_shift_filter_tile", lab_p)
    th, tw = lab_p.shape[0] - 2 * E, lab_p.shape[1] - 2 * E
    if th < 1 or tw < 1:
        raise ValueError(f"mean_shift_filter_tile: a {lab_p.shape[0]}x"
                         f"{lab_p.shape[1]} tile has no core inside an "
                         f"{E}-pixel halo")
    if lab_p.device.type == "cpu":
        return mean_shift_filter_tile_plain(lab_p, row0, col0, E,
                                            kernel_spatial, kernel_intensity,
                                            iters)
    pos, col, _, _ = _launch(lab_p, lab_p, th, tw, E, row0, col0, E,
                             kernel_spatial, kernel_intensity, iters, False,
                             False)
    LAUNCHES_TILE += 1
    return pos, col
