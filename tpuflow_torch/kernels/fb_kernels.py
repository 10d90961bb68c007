"""Farneback polynomial expansion and box aggregation + solve: the CUDA
kernels and their plain versions.

Counterparts of ``tpuflow/kernels/fb_kernels.py``:

- :func:`fb_poly_expansion` (``fb_poly_expansion_pallas``): on a
  CLAMP-padded (H + 2n, W + 2n) image, three row passes (g, g*x, g*x^2)
  feed six column passes, the moments in basis order [1, x, y, x^2, y^2,
  xy], which five rows of G^-1 combine into (b1, b2, a11, a22, a12), each
  (H, W). A G^-1 coefficient that is exactly zero is skipped.
- :func:`fb_blur_solve` (``fb_blur_solve_pallas``): on the edge-padded
  5-channel field M, a VALID winsize x winsize box sum per channel,
  times 1/winsize^2, then the per-pixel 2x2 solve with |det| clamped at
  1e-9. Returns (u, v) of the VALID shape; an even winsize gives one
  extra row and column, which the caller crops.

Taps and coefficients are rounded once on the host to the image's dtype.
Both versions multiply by the rounded values and add in the same order,
so on the card each kernel (``csrc/fb_kernels.cu``, one launch each; both
stream each column, then each row, past register accumulators in tap
order, with poly_n 5 and 8 and winsize 48 and 64 compiled in) matches its
plain version bitwise. CPU tensors take the plain versions; CUDA tensors
take the kernels or raise.

The form is picked by the shape alone (:func:`poly_form`,
:func:`blur_form`): where one block's intermediates fit its shared memory
(poly up to ~1,000 taps, above MAX_POLY_TAPS with the taps copied to the
card; blur-solve up to winsize ~600) one launch, else the wide form: two
launches, one thread an output each, the vertical sums in device scratch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpuflow_torch.kernels import _build
from tpuflow_torch.kernels.sepconv import _pass, device_taps, host_taps

# Launches of each CUDA kernel in this process (never the plain versions).
LAUNCHES = {"fb_poly_expansion": 0, "fb_blur_solve": 0}
# Blur-solve's output tile of one block and its thread count
# (csrc/fb_kernels.cu's BH, BW, B_THREADS), the rows a thread sums in a
# vertical pass and the outputs in a horizontal one (BV, BR), and the
# channels whose row sums shared memory holds at once (B_GROUP): planes of
# TILE_H x (TILE_W + winsize - 1) floats, an odd pitch.
TILE_H = 16
TILE_W = 128
THREADS = 256
BLUR_ROWS_ACC = 16
BLUR_ACC = 8
BLUR_GROUP = 5
# Winsizes compiled into an instantiation of their own
# (csrc/fb_kernels.cu's blur_kernel_for): the FB stream's 48 and the
# demo's 64. Every other winsize takes the instantiation with it at run
# time; both sum in the same order.
BLUR_COMPILED_WINSIZES = (48, 64)
# The expansion's output tile, threads and outputs a thread accumulates in
# a pass (csrc/fb_kernels.cu's PH, PW, P_THREADS, PR): the vertical passes
# put POLY_TILE_H x (POLY_TILE_W + taps - 1) intermediates of each of g,
# gx, gxx in shared memory (rows of an odd pitch), which three of the
# outputs then take over; the other two have POLY_TILE_H x (POLY_TILE_W +
# 1) tiles of their own.
POLY_TILE_H = 16
POLY_TILE_W = 128
POLY_THREADS = 256
POLY_ACC = 8
# Taps the poly kernel's parameter struct holds (2n + 1 <= 64);
# poly_smem_bytes(MAX_POLY_TAPS) fits one block. A larger count takes its
# taps from device memory (the DEVICE_TAPS instantiation).
MAX_POLY_TAPS = 64
DEVICE_TAPS = -1
# Tap counts compiled into an instantiation of their own
# (csrc/fb_kernels.cu's poly_kernel_for): poly_n 5 and 8. Every other
# count takes the instantiation with the count at run time; both sum in
# the same order.
POLY_COMPILED_TAPS = (11, 17)


def poly_instantiation(taps: int) -> int:
    """The template argument of the poly kernel that runs ``taps`` taps:
    the count where it is compiled in, DEVICE_TAPS where the parameter
    struct cannot hold it, else 0."""
    if taps > MAX_POLY_TAPS:
        return DEVICE_TAPS
    return taps if taps in POLY_COMPILED_TAPS else 0


def blur_instantiation(winsize: int) -> int:
    """The template argument of the blur-solve kernel that runs
    ``winsize``: the winsize where it is compiled in, else 0."""
    return winsize if winsize in BLUR_COMPILED_WINSIZES else 0


def poly_form(taps: int) -> str:
    """"staged" (one launch) where one block's intermediates fit its shared
    memory, else "wide" (two launches)."""
    return ("staged" if poly_smem_bytes(taps) <= _build.MAX_SMEM_BYTES
            else "wide")


def blur_form(winsize: int) -> str:
    """"staged" (one launch) where one block's row sums fit its shared
    memory, else "wide" (two launches)."""
    return ("staged" if blur_smem_bytes(winsize) <= _build.MAX_SMEM_BYTES
            else "wide")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from csrc/fb_kernels.cu."""
    lib.fb_poly_expansion_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.fb_poly_expansion_launch.restype = ctypes.c_int
    lib.fb_poly_expansion_wide_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    lib.fb_poly_expansion_wide_launch.restype = ctypes.c_int
    lib.fb_poly_expansion_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.fb_poly_expansion_blocks_per_sm.restype = ctypes.c_int
    lib.fb_blur_solve_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.fb_blur_solve_launch.restype = ctypes.c_int
    lib.fb_blur_solve_wide_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float]
        + [ctypes.c_void_p])
    lib.fb_blur_solve_wide_launch.restype = ctypes.c_int
    lib.fb_blur_solve_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.fb_blur_solve_blocks_per_sm.restype = ctypes.c_int
    lib.fb_kernels_error_string.argtypes = [ctypes.c_int]
    lib.fb_kernels_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    return _bind(_build.load("fb_kernels"))


def poly_smem_bytes(taps: int) -> int:
    return 4 * POLY_TILE_H * (3 * ((POLY_TILE_W + taps - 1) | 1)
                              + 2 * (POLY_TILE_W + 1))


def poly_blocks_per_sm(taps: int) -> int:
    """Blocks of the poly kernel one SM of the current card holds at once
    for ``taps`` taps (CUDA's occupancy calculator)."""
    lib = _lib()
    n = lib.fb_poly_expansion_blocks_per_sm(taps)
    _build.check_launch(lib, "fb_kernels", -n if n < 0 else 0)
    return n


def blur_smem_bytes(winsize: int) -> int:
    return 4 * BLUR_GROUP * TILE_H * ((TILE_W + winsize - 1) | 1)


def blur_blocks_per_sm(winsize: int) -> int:
    """Blocks of the blur-solve kernel one SM of the current card holds at
    once at ``winsize`` (CUDA's occupancy calculator)."""
    lib = _lib()
    n = lib.fb_blur_solve_blocks_per_sm(winsize)
    _build.check_launch(lib, "fb_kernels", -n if n < 0 else 0)
    return n


# -- polynomial expansion ---------------------------------------------------


def _weighted_sum(terms) -> torch.Tensor | None:
    """sum of coef * m over (coef, m), skipping zero coefficients; the first
    kept term starts the sum."""
    acc = None
    for coef, m in terms:
        if coef == 0.0:
            continue
        t = m * float(coef)
        acc = t if acc is None else acc + t
    return acc


def fb_poly_expansion_plain(padded, g, gx, gxx, ginv):
    """The kernel's arithmetic in plain PyTorch: taps and the (5, 6)
    ``ginv`` rows as rounded by :func:`fb_poly_expansion`."""
    n_taps = len(g)
    ho = padded.shape[0] - n_taps + 1
    wo = padded.shape[1] - n_taps + 1
    rg = _pass(padded, g, 0, ho)
    rgx = _pass(padded, gx, 0, ho)
    rgxx = _pass(padded, gxx, 0, ho)
    m = (_pass(rg, g, 1, wo), _pass(rg, gx, 1, wo), _pass(rgx, g, 1, wo),
         _pass(rg, gxx, 1, wo), _pass(rgxx, g, 1, wo), _pass(rgx, gx, 1, wo))
    outs = []
    for row in ginv:
        acc = _weighted_sum(zip(row, m))
        outs.append(torch.zeros_like(m[0]) if acc is None else acc)
    return tuple(outs)


def fb_poly_expansion(padded: torch.Tensor, g, gx, gxx, ginv):
    """(b1, b2, a11, a22, a12) of a CLAMP-padded (Hp, Wp) image.

    ``g``/``gx``/``gxx`` are the 2n+1 applicability taps, ``ginv`` the
    (5, 6) rows 1-4 and 0.5 x row 5 of G^-1; each output is
    (Hp - 2n, Wp - 2n). CPU tensors take :func:`fb_poly_expansion_plain`;
    a CUDA tensor (contiguous float32) takes one kernel launch, or two of
    its wide form (:func:`poly_form`), or raises.
    """
    _build.check_fields("fb_poly_expansion", padded)
    g, gx, gxx = (host_taps(t, padded.dtype) for t in (g, gx, gxx))
    ginv = host_taps(ginv, padded.dtype).reshape(5, 6)
    n_taps = len(g)
    hp, wp = padded.shape
    if len(gx) != n_taps or len(gxx) != n_taps or hp < n_taps \
            or wp < n_taps:
        raise ValueError(f"fb_poly_expansion: taps ({len(g)}, {len(gx)}, "
                         f"{len(gxx)}) do not fit the padded image "
                         f"({hp}, {wp})")
    if padded.device.type == "cpu":
        return fb_poly_expansion_plain(padded, g, gx, gxx, ginv)
    if poly_form(n_taps) == "wide":
        return _poly_wide_launch(padded, g, gx, gxx, ginv)
    return _poly_launch(padded, g, gx, gxx, ginv)


def _poly_launch(padded, g, gx, gxx, ginv):
    """One launch of fb_poly_expansion_kernel (arguments as
    :func:`fb_poly_expansion_plain`'s)."""
    lib = _lib()
    n_taps = len(g)
    hp, wp = padded.shape
    outs = [padded.new_empty((hp - n_taps + 1, wp - n_taps + 1))
            for _ in range(5)]
    with torch.cuda.device(padded.device):
        dev = (None if poly_instantiation(n_taps) != DEVICE_TAPS
               else device_taps(padded.device, g, gx, gxx))
        rc = lib.fb_poly_expansion_launch(
            padded.data_ptr(), *(o.data_ptr() for o in outs), hp, wp,
            g.ctypes.data, gx.ctypes.data, gxx.ctypes.data, n_taps,
            ginv.ctypes.data, None if dev is None else dev.data_ptr(),
            POLY_TILE_H, POLY_TILE_W, POLY_THREADS,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "fb_kernels", rc)
    LAUNCHES["fb_poly_expansion"] += 1
    return tuple(outs)


def _poly_wide_launch(padded, g, gx, gxx, ginv):
    """The wide form: rg, rgx, rgxx into device scratch, then the six
    column passes and G^-1, two launches (arguments as
    :func:`fb_poly_expansion_plain`'s)."""
    lib = _lib()
    n_taps = len(g)
    hp, wp = padded.shape
    rows = padded.new_empty((3, hp - n_taps + 1, wp))
    outs = [padded.new_empty((hp - n_taps + 1, wp - n_taps + 1))
            for _ in range(5)]
    with torch.cuda.device(padded.device):
        dev = device_taps(padded.device, g, gx, gxx)
        rc = lib.fb_poly_expansion_wide_launch(
            padded.data_ptr(), rows.data_ptr(), *(o.data_ptr() for o in outs),
            hp, wp, dev.data_ptr(), n_taps, ginv.ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "fb_kernels", rc)
    LAUNCHES["fb_poly_expansion"] += 2
    return tuple(outs)


# -- box aggregation + solve -------------------------------------------------


def _box_sum_valid(a: torch.Tensor, winsize: int) -> torch.Tensor:
    """VALID winsize x winsize box sum over the trailing two dims: rows
    added top to bottom, then columns left to right."""
    ho = a.shape[-2] - winsize + 1
    wo = a.shape[-1] - winsize + 1
    rows = a[..., 0:ho, :]
    for d in range(1, winsize):
        rows = rows + a[..., d : d + ho, :]
    out = rows[..., 0:wo]
    for d in range(1, winsize):
        out = out + rows[..., d : d + wo]
    return out


def solve_2x2(m11, m12, m22, h1, h2):
    """Per-pixel 2x2 solve with |det| clamped at 1e-9 -> (u, v)."""
    det = m11 * m22 - m12 * m12
    det = torch.where(det.abs() < 1e-9, 1e-9, det)
    return (m22 * h1 - m12 * h2) / det, (m11 * h2 - m12 * h1) / det


def fb_blur_solve_plain(m_padded: torch.Tensor, winsize: int):
    """The kernel's arithmetic in plain PyTorch."""
    inv_area = float(host_taps([1.0 / (winsize * winsize)],
                               m_padded.dtype)[0])
    blurred = _box_sum_valid(m_padded, winsize) * inv_area
    return solve_2x2(*blurred)


def fb_blur_solve(m_padded: torch.Tensor, winsize: int):
    """Box aggregation + 2x2 solve of an edge-padded (5, Hp, Wp) field.

    Returns (u, v), each (Hp - winsize + 1, Wp - winsize + 1). CPU tensors
    take :func:`fb_blur_solve_plain`; a CUDA tensor (contiguous float32)
    takes one kernel launch, or two of its wide form (:func:`blur_form`),
    or raises. Any winsize >= 1 is taken, odd or even.
    """
    if m_padded.dim() != 3 or m_padded.shape[0] != 5:
        raise ValueError("fb_blur_solve: M must be (5, Hp, Wp), got "
                         f"{tuple(m_padded.shape)}")
    _build.check_fields("fb_blur_solve", *m_padded.unbind(0))
    _, hp, wp = m_padded.shape
    if winsize < 1 or hp < winsize or wp < winsize:
        raise ValueError(f"fb_blur_solve: winsize {winsize} does not fit "
                         f"the padded field ({hp}, {wp})")
    if m_padded.device.type == "cpu":
        return fb_blur_solve_plain(m_padded, winsize)
    if not m_padded.is_contiguous():
        raise ValueError("fb_blur_solve: the CUDA kernel takes a contiguous M")
    if blur_form(winsize) == "wide":
        return _blur_wide_launch(m_padded, winsize)
    return _blur_launch(m_padded, winsize)


def _blur_launch(m_padded, winsize):
    """One launch of fb_blur_solve_kernel (arguments as
    :func:`fb_blur_solve_plain`'s)."""
    lib = _lib()
    _, hp, wp = m_padded.shape
    u = m_padded.new_empty((hp - winsize + 1, wp - winsize + 1))
    v = torch.empty_like(u)
    with torch.cuda.device(m_padded.device):
        rc = lib.fb_blur_solve_launch(
            m_padded.data_ptr(), u.data_ptr(), v.data_ptr(), hp, wp, winsize,
            1.0 / (winsize * winsize), TILE_H, TILE_W, THREADS,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "fb_kernels", rc)
    LAUNCHES["fb_blur_solve"] += 1
    return u, v


def _blur_wide_launch(m_padded, winsize):
    """The wide form: the five channels' row sums into device scratch,
    then the column sums and the solve, two launches (arguments as
    :func:`fb_blur_solve_plain`'s)."""
    lib = _lib()
    _, hp, wp = m_padded.shape
    rows = m_padded.new_empty((5, hp - winsize + 1, wp))
    u = m_padded.new_empty((hp - winsize + 1, wp - winsize + 1))
    v = torch.empty_like(u)
    with torch.cuda.device(m_padded.device):
        rc = lib.fb_blur_solve_wide_launch(
            m_padded.data_ptr(), rows.data_ptr(), u.data_ptr(), v.data_ptr(),
            hp, wp, winsize, 1.0 / (winsize * winsize),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "fb_kernels", rc)
    LAUNCHES["fb_blur_solve"] += 2
    return u, v
