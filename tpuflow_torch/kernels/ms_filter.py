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
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpuflow_torch.kernels import _build

# Launches of the CUDA kernel in this process (never the plain version).
LAUNCHES = 0
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
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
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


def mean_shift_filter_plain(lab: torch.Tensor, kernel_spatial: int = 20,
                            kernel_intensity: float = 16.0 / 255.0,
                            iters: int = 8, margin: int | None = None):
    """The kernel's function in plain PyTorch; returns (pos (H, W, 2) xy,
    color (H, W, 3)). One pass of ~25 elementwise ops per offset."""
    from tpuflow_torch.segmentation.meanshift import _color_sentinel

    h, w = lab.shape[:2]
    dt = lab.dtype
    E = window(kernel_spatial, margin)
    hs2 = float(kernel_spatial) ** 2
    hr2 = float(kernel_intensity) ** 2
    planes = lab.permute(2, 0, 1)
    labh = _color_sentinel(lab, kernel_intensity).expand(
        3, h + 2 * E, w + 2 * E).clone()
    labh[:, E : E + h, E : E + w] = planes
    xs = torch.arange(w, dtype=dt, device=lab.device)[None, :].expand(h, w)
    ys = torch.arange(h, dtype=dt, device=lab.device)[:, None].expand(h, w)

    ex = torch.zeros((h, w), dtype=dt, device=lab.device)
    ey = torch.zeros_like(ex)
    c0, c1, c2 = planes[0], planes[1], planes[2]
    for _ in range(iters):
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
    return (torch.stack([xs + ex, ys + ey], dim=-1),
            torch.stack([c0, c1, c2], dim=-1))


def mean_shift_filter(lab: torch.Tensor, kernel_spatial: int = 20,
                      kernel_intensity: float = 16.0 / 255.0,
                      iters: int = 8, margin: int | None = None):
    """``iters`` mean-shift steps; returns (pos (H, W, 2) xy, color (H, W, 3)).

    CPU tensors take :func:`mean_shift_filter_plain`; a CUDA tensor
    (contiguous float32 (H, W, 3)) takes one launch of the CUDA kernel in
    the form :func:`form_for` picks, or raises.
    """
    global LAUNCHES
    if lab.dim() != 3 or lab.shape[-1] != 3:
        raise ValueError(f"mean_shift_filter: need (H, W, 3) Lab, got "
                         f"{tuple(lab.shape)}")
    if lab.device.type == "cpu":
        return mean_shift_filter_plain(lab, kernel_spatial, kernel_intensity,
                                       iters, margin)
    if lab.device.type != "cuda":
        raise ValueError(f"mean_shift_filter: no kernel for {lab.device}")
    if lab.dtype != torch.float32 or not lab.is_contiguous():
        raise TypeError("mean_shift_filter: the CUDA kernel takes contiguous "
                        f"float32, got {lab.dtype}")
    from tpuflow_torch.segmentation.meanshift import _color_sentinel

    E = window(kernel_spatial, margin)
    h, w = lab.shape[:2]
    th = tile_rows(E)
    lib = _lib()
    sentinel = _color_sentinel(lab, kernel_intensity)
    pos = torch.empty((h, w, 2), dtype=lab.dtype, device=lab.device)
    col = torch.empty_like(lab)
    with torch.cuda.device(lab.device):
        rc = lib.ms_filter_launch(
            lab.data_ptr(), sentinel.data_ptr(), pos.data_ptr(),
            col.data_ptr(), h, w, E, math.ceil(kernel_spatial), int(iters),
            th, int(form_for(E) == "wide"), float(kernel_spatial) ** 2,
            float(kernel_intensity) ** 2,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "ms_filter", rc)
    LAUNCHES += 1
    return pos, col
