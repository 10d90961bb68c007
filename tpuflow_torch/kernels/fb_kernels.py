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
so on the card each kernel (``csrc/fb_kernels.cu``, one launch each; the
expansion streams each column, then each row, past register accumulators
in tap order, with poly_n 5 and 8 compiled in) matches its plain version
bitwise. CPU tensors take the plain versions; CUDA tensors take the
kernels or raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpuflow_torch.kernels import _build
from tpuflow_torch.kernels.sepconv import _pass, host_taps

# Launches of each CUDA kernel in this process (never the plain versions).
LAUNCHES = {"fb_poly_expansion": 0, "fb_blur_solve": 0}
# Blur-solve's output tile of one block and its thread count.
TILE_H = 32
TILE_W = 64
THREADS = 256
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
# poly_smem_bytes(MAX_POLY_TAPS) fits one block.
MAX_POLY_TAPS = 64
# Tap counts compiled into an instantiation of their own
# (csrc/fb_kernels.cu's poly_kernel_for): poly_n 5 and 8. Every other
# count takes the instantiation with the count at run time; both sum in
# the same order.
POLY_COMPILED_TAPS = (11, 17)


def poly_instantiation(taps: int) -> int:
    """The template argument of the poly kernel that runs ``taps`` taps:
    the count where it is compiled in, else 0."""
    return taps if taps in POLY_COMPILED_TAPS else 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from csrc/fb_kernels.cu."""
    lib.fb_poly_expansion_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.fb_poly_expansion_launch.restype = ctypes.c_int
    lib.fb_poly_expansion_blocks_per_sm.argtypes = [ctypes.c_int]
    lib.fb_poly_expansion_blocks_per_sm.restype = ctypes.c_int
    lib.fb_blur_solve_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.fb_blur_solve_launch.restype = ctypes.c_int
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
    return 4 * ((TILE_H + winsize - 1 + TILE_H) * (TILE_W + winsize - 1)
                + 5 * TILE_H * TILE_W)


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
    a CUDA tensor (contiguous float32) takes one kernel launch, or raises.
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
    if n_taps > MAX_POLY_TAPS:
        raise ValueError(f"fb_poly_expansion: the CUDA kernel takes at most "
                         f"{MAX_POLY_TAPS} taps, got {n_taps}")
    lib = _lib()
    outs = [torch.empty((hp - n_taps + 1, wp - n_taps + 1),
                        dtype=padded.dtype, device=padded.device)
            for _ in range(5)]
    with torch.cuda.device(padded.device):
        rc = lib.fb_poly_expansion_launch(
            padded.data_ptr(), *(o.data_ptr() for o in outs), hp, wp,
            g.ctypes.data, gx.ctypes.data, gxx.ctypes.data, n_taps,
            ginv.ctypes.data, POLY_TILE_H, POLY_TILE_W, POLY_THREADS,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "fb_kernels", rc)
    LAUNCHES["fb_poly_expansion"] += 1
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
    takes one kernel launch, or raises. Any winsize >= 1 whose window
    fits one block's shared memory is taken, odd or even.
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
    smem = blur_smem_bytes(winsize)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"fb_blur_solve: winsize {winsize} needs {smem} B "
                         f"of shared memory per block "
                         f"(> {_build.MAX_SMEM_BYTES})")
    lib = _lib()
    u = torch.empty((hp - winsize + 1, wp - winsize + 1),
                    dtype=m_padded.dtype, device=m_padded.device)
    v = torch.empty_like(u)
    with torch.cuda.device(m_padded.device):
        rc = lib.fb_blur_solve_launch(
            m_padded.data_ptr(), u.data_ptr(), v.data_ptr(), hp, wp, winsize,
            1.0 / (winsize * winsize), TILE_H, TILE_W, THREADS,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "fb_kernels", rc)
    LAUNCHES["fb_blur_solve"] += 1
    return u, v
