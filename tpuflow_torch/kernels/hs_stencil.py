"""Fused Horn-Schunck Jacobi sweeps: the CUDA kernel and its plain version.

Counterpart of ``tpuflow/kernels/hs_stencil.py::horn_schunck_pallas``. The
demo solver (HornSchunckOF/hornSchunck.cpp:43-75) iterates

    ub = box_{W x W}(u)          (BORDER_CONSTANT zeros)
    upd = (gx*ub + gy*vb + gt) * inv_denom
    u   = ub - gx * upd,   v = vb - gy * upd

:func:`hs_sweeps` runs ``fuse`` of these sweeps: on a CUDA tensor through
``csrc/hs_stencil.cu`` (one launch; the source says what bounds it on the
H100 and how the fused design answers), on a CPU tensor through
:func:`hs_sweeps_plain`. :func:`horn_schunck_fused` is the whole solve in
``max_iterations // fuse`` launches plus one remainder launch, as
``horn_schunck_pallas`` runs its blocks. The TPU tiling knobs (tile
alignment, ``pipelined``, ``mxu``, ``roll``, ``interpret``) have no
counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from tpuflow_torch.core import borders as bd
from tpuflow_torch.kernels import _build

# Launches of the CUDA kernel in this process (never the plain version).
LAUNCHES = 0
# Core tile of one block and its thread count. The shared tile is the core
# plus a fuse*r halo on each side: 8 float fields, so
# 8 * 4 * (TILE_H + 2*fuse*r) * (TILE_W + 2*fuse*r) bytes.
# Chosen by a sweep of tiles, threads and fuse on the H100 (PERF.md).
TILE_H = 32
TILE_W = 64
THREADS = 512
# Sweeps per launch on the card, by the same sweep (the TPU's was 10).
DEFAULT_FUSE = 3


def _lib() -> ctypes.CDLL:
    lib = _build.load("hs_stencil")
    lib.hs_sweeps_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.hs_sweeps_launch.restype = ctypes.c_int
    lib.hs_sweeps_error_string.argtypes = [ctypes.c_int]
    lib.hs_sweeps_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(window: int, fuse: int) -> int:
    halo = fuse * (window // 2)
    return 8 * 4 * (TILE_H + 2 * halo) * (TILE_W + 2 * halo)


def _box_sum(a: torch.Tensor, window: int) -> torch.Tensor:
    """window x window box sum with zeros beyond the frame, in the TPU
    kernel's order: vertical sums per column, then columns left to right."""
    h, w = a.shape
    p = bd.pad2d(a, window // 2, bd.ZERO)
    rows = p[0:h, :]
    for d in range(1, window):
        rows = rows + p[d : d + h, :]
    out = rows[:, 0:w]
    for d in range(1, window):
        out = out + rows[:, d : d + w]
    return out


def hs_sweeps_plain(u, v, gx, gy, gt, inv_denom, window: int = 5,
                    fuse: int = 1):
    """``fuse`` HS Jacobi sweeps in plain PyTorch; returns (u, v)."""
    inv_area = 1.0 / (window * window)
    for _ in range(fuse):
        ub = _box_sum(u, window) * inv_area
        vb = _box_sum(v, window) * inv_area
        upd = (gx * ub + gy * vb + gt) * inv_denom
        u = ub - gx * upd
        v = vb - gy * upd
    return u, v


def hs_sweeps(u, v, gx, gy, gt, inv_denom, window: int = 5, fuse: int = 1):
    """``fuse`` HS Jacobi sweeps; returns new (u, v).

    CPU tensors take :func:`hs_sweeps_plain`; CUDA tensors (contiguous
    float32, one shape) take one launch of the CUDA kernel, or raise.
    """
    global LAUNCHES
    _build.check_fields("hs_sweeps", u, v, gx, gy, gt, inv_denom)
    if window < 1 or window % 2 == 0 or fuse < 1:
        raise ValueError(f"hs_sweeps: need an odd window and fuse >= 1, "
                         f"got window={window}, fuse={fuse}")
    if u.device.type == "cpu":
        return hs_sweeps_plain(u, v, gx, gy, gt, inv_denom, window, fuse)
    smem = smem_bytes(window, fuse)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"hs_sweeps: fuse={fuse} at window={window} needs "
                         f"{smem} B of shared memory per block "
                         f"(> {_build.MAX_SMEM_BYTES})")
    lib = _lib()
    h, w = u.shape
    u_out = torch.empty_like(u)
    v_out = torch.empty_like(v)
    with torch.cuda.device(u.device):
        rc = lib.hs_sweeps_launch(
            u.data_ptr(), v.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            gt.data_ptr(), inv_denom.data_ptr(), u_out.data_ptr(),
            v_out.data_ptr(), h, w, TILE_H, TILE_W, window, fuse,
            1.0 / (window * window), THREADS,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "hs_sweeps", rc)
    LAUNCHES += 1
    return u_out, v_out


def hs_iterate(u, v, gx, gy, gt, inv_denom, window: int, n_iters: int,
               fuse: int):
    """``n_iters`` sweeps as ``n_iters // fuse`` blocks of ``fuse`` plus
    one remainder block (tpuflow/kernels/hs_stencil.py:817-823)."""
    n_full, rem = divmod(n_iters, fuse)
    for _ in range(n_full):
        u, v = hs_sweeps(u, v, gx, gy, gt, inv_denom, window, fuse)
    if rem:
        u, v = hs_sweeps(u, v, gx, gy, gt, inv_denom, window, rem)
    return u, v


def horn_schunck_fused(prev: torch.Tensor, next: torch.Tensor,
                       window_size: int = 5, max_iterations: int = 100,
                       alpha: float = 1.0, fuse: int = DEFAULT_FUSE):
    """Horn-Schunck flow with the fused sweep. Returns (u, v).

    Same gradients and BORDER_CONSTANT box average as
    :func:`tpuflow_torch.solvers.horn_schunck.horn_schunck`; ``fuse`` sets
    the sweeps per launch.
    """
    from tpuflow_torch.solvers.horn_schunck import hs_gradients

    gx, gy, gt = hs_gradients(prev, next)
    inv_denom = 1.0 / (alpha * alpha + gx * gx + gy * gy)
    u = torch.zeros_like(gt)
    v = torch.zeros_like(gt)
    return hs_iterate(u, v, gx, gy, gt, inv_denom, window_size,
                      max_iterations, fuse)
