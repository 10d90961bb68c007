"""Fused Horn-Schunck Jacobi sweeps: the CUDA kernel and its plain version.

Counterpart of ``tpuflow/kernels/hs_stencil.py::horn_schunck_pallas``. The
demo solver (HornSchunckOF/hornSchunck.cpp:43-75) iterates

    ub = box_{W x W}(u)          (BORDER_CONSTANT zeros)
    upd = (gx*ub + gy*vb + gt) * inv_denom
    u   = ub - gx * upd,   v = vb - gy * upd

:func:`hs_sweeps` runs ``fuse`` of these sweeps: on a CUDA tensor through
``csrc/hs_stencil.cu`` (one launch of at most :func:`max_fuse` sweeps, a
deeper block as several; the source says what bounds it on the H100 and
how the fused design answers: each box sum is taken as column sums, then
those summed along the row, which is the plain version's order), on a CPU
tensor through :func:`hs_sweeps_plain`. A window of 65 or more, whose halo
leaves no core in the staged tile even for one sweep (:func:`max_fuse` 0),
takes the wide form on the card: per sweep one column-sum and one update
kernel (:func:`hs_wide_sweeps`, two launches), in the same order.
:func:`horn_schunck_fused` is the whole solve in
``max_iterations // fuse`` launches plus one remainder launch, as
``horn_schunck_pallas`` runs its blocks. The TPU tiling knobs (tile
alignment, ``pipelined``, ``mxu``, ``roll``, ``interpret``) have no
counterpart here.

:func:`hs_tile_sweeps` is ``hs_tile_sweeps``, the tile body of the sharded
solver (:mod:`tpuflow_torch.dist.solvers`): the same sweeps on one halo'd
tile at a frame offset, through the same CUDA source (a deep block as
several launches, each taking the last one's core:
:func:`tpuflow_torch.kernels._build.split_fuse`; a window of 65 or more
through the wide form, :func:`hs_wide_tile_sweeps`).
:func:`horn_schunck_resident` and :func:`horn_schunck_resident2` are
``horn_schunck_pallas_resident``/``_resident2``: the whole solve in one
launch of ``csrc/hs_resident.cu``, :data:`RESIDENT_FUSE` sweeps between
grid syncs (the wide form, one sweep at a time, at a window of 65 or
more: :func:`resident_plan`). ``strip`` (a Mosaic register-spill
workaround) and ``interpret`` have no counterpart.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from tpuflow_torch.core import borders as bd
from tpuflow_torch.kernels import _build
from tpuflow_torch.kernels.fb_kernels import _box_sum_valid

# Launches of the CUDA kernels in this process (never the plain versions):
# hs_sweeps, hs_tile_sweeps, horn_schunck_resident and _resident2. A sweep
# of the wide form counts its two kernels.
LAUNCHES = 0
LAUNCHES_TILE = 0
LAUNCHES_RESIDENT = 0
LAUNCHES_RESIDENT2 = 0
# The staged tile of one block (rows, columns) and its threads, as
# csrc/hs_stencil.cu compiles them: u, v and their column sums in shared
# memory (4 float fields), gx, gy, gt and inv_denom in the threads'
# registers. A block writes the tile less a fuse*r halo on each side.
# Chosen by a sweep of staged tiles on the H100 (PERF.md).
STAGE = (64, 64)
THREADS = 512
BLOCKS_PER_SM = 2
# Sweeps per launch on the card (the TPU's was 10).
DEFAULT_FUSE = 3
# Sweeps the resident kernel runs between two grid syncs, at most (it
# stages STAGE as hs_sweeps does, with the same block body).
RESIDENT_FUSE = 3


def _lib() -> ctypes.CDLL:
    lib = _build.load("hs_stencil")
    lib.hs_sweeps_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    lib.hs_sweeps_launch.restype = ctypes.c_int
    lib.hs_tile_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_void_p])
    lib.hs_tile_launch.restype = ctypes.c_int
    lib.hs_wide_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p])
    lib.hs_wide_launch.restype = ctypes.c_int
    lib.hs_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.hs_blocks_per_sm.restype = ctypes.c_int
    lib.hs_sweeps_error_string.argtypes = [ctypes.c_int]
    lib.hs_sweeps_error_string.restype = ctypes.c_char_p
    return lib


def _lib_resident() -> ctypes.CDLL:
    lib = _build.load("hs_resident")
    lib.hs_resident_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
        + [ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    lib.hs_resident_launch.restype = ctypes.c_int
    lib.hs_resident_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    lib.hs_resident_blocks_per_sm.restype = ctypes.c_int
    lib.hs_resident_error_string.argtypes = [ctypes.c_int]
    lib.hs_resident_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(window: int, fuse: int) -> int:
    """u, v and their column sums of the staged tile: the same at every
    window and fuse that :func:`tile_for` accepts."""
    tile_for(window, fuse)
    return 4 * 4 * STAGE[0] * STAGE[1]


def tile_for(window: int, fuse: int, name: str = "hs_tile_sweeps"
             ) -> tuple[int, int]:
    """The core one block writes for ``fuse`` sweeps: the staged tile less
    a fuse*r halo on each side. Raises if nothing is left."""
    return _build.core(f"{name}: fuse={fuse} at window={window}", STAGE,
                       fuse * (window // 2))


def max_fuse(window: int) -> int:
    """The most sweeps one launch of the staged kernels takes at
    ``window``: the deepest fuse whose halo leaves a core in the staged
    tile. 0 where one sweep's halo does not (a window of 65 or more): such
    a window runs the wide form, one sweep per two launches."""
    r = window // 2
    return _build.max_halo(STAGE) // r if r else sys.maxsize


def blocks_per_sm(tile: bool, window: int) -> int:
    """Blocks of the sweeps (``tile`` False) or the tile kernel one SM of
    the current card holds at once (CUDA's occupancy calculator)."""
    lib = _lib()
    n = lib.hs_blocks_per_sm(int(tile), window)
    _build.check_launch(lib, "hs_sweeps", -n if n < 0 else 0)
    return n


def blocks_per_sm_resident(window: int, recip: bool) -> int:
    """Blocks of the resident kernel one SM of the current card holds at
    ``window`` (the staged or the wide form, as :func:`resident_plan`
    picks)."""
    lib = _lib_resident()
    n = lib.hs_resident_blocks_per_sm(window, int(recip),
                                      resident_plan(window, 1)[0])
    _build.check_launch(lib, "hs_resident", -n if n < 0 else 0)
    return n


def _box_sum(a: torch.Tensor, window: int) -> torch.Tensor:
    """window x window box sum with zeros beyond the frame, in the TPU
    kernel's order: vertical sums per column, then columns left to right."""
    return _box_sum_valid(bd.pad2d(a, window // 2, bd.ZERO), window)


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
    float32, one shape) take ceil(fuse / max_fuse(window)) launches of the
    CUDA kernel, or at a window of 65 or more 2 * fuse launches of the
    wide form (:func:`hs_wide_sweeps`), or raise.
    """
    _build.check_fields("hs_sweeps", u, v, gx, gy, gt, inv_denom)
    if window < 1 or window % 2 == 0 or fuse < 1:
        raise ValueError(f"hs_sweeps: need an odd window and fuse >= 1, "
                         f"got window={window}, fuse={fuse}")
    if u.device.type == "cpu":
        return hs_sweeps_plain(u, v, gx, gy, gt, inv_denom, window, fuse)
    if not max_fuse(window):
        return hs_wide_sweeps(u, v, gx, gy, gt, inv_denom, window, fuse)
    return _split_sweeps(_sweeps_launch, u, v, gx, gy, gt, inv_denom, window,
                         fuse)


def _split_sweeps(launch, u, v, gx, gy, gt, inv_denom, window, fuse,
                  f_max=None):
    """``fuse`` sweeps as ceil(fuse / f_max) calls of ``launch``, which
    takes :func:`hs_sweeps_plain`'s arguments and runs at most ``f_max``
    sweeps (default: :func:`max_fuse` of ``window``)."""
    return _build.split_fuse(
        lambda u, v, fixed, off, k: launch(u, v, *fixed, window, k),
        u, v, fuse, f_max or max_fuse(window), (gx, gy, gt, inv_denom))


def _sweeps_launch(u, v, gx, gy, gt, inv_denom, window, fuse):
    """One launch of hs_sweeps_kernel (arguments as
    :func:`hs_sweeps_plain`'s)."""
    global LAUNCHES
    tile_for(window, fuse, "hs_sweeps")
    lib = _lib()
    h, w = u.shape
    u_out = torch.empty_like(u)
    v_out = torch.empty_like(v)
    with torch.cuda.device(u.device):
        rc = lib.hs_sweeps_launch(
            u.data_ptr(), v.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            gt.data_ptr(), inv_denom.data_ptr(), u_out.data_ptr(),
            v_out.data_ptr(), h, w, window, fuse, 1.0 / (window * window),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "hs_sweeps", rc)
    LAUNCHES += 1
    return u_out, v_out


def _wide_launch(u, v, gx, gy, gt, inv, out_shape, off, g0, fy0, fx0,
                 img_h, img_w, window):
    """One sweep of the wide form (two kernels) on (u, v), whose (0, 0) is
    frame cell (fy0, fx0), into an ``out_shape`` result whose (0, 0) is
    input cell (off, off); the fixed fields are read from (g0, g0)."""
    lib = _lib()
    in_h, in_w = u.shape
    u_out = u.new_empty(out_shape)
    v_out = torch.empty_like(u_out)
    cs_u = u.new_empty((out_shape[0], in_w))
    cs_v = torch.empty_like(cs_u)
    with torch.cuda.device(u.device):
        rc = lib.hs_wide_launch(
            u.data_ptr(), v.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            gt.data_ptr(), inv.data_ptr(), u_out.data_ptr(),
            v_out.data_ptr(), cs_u.data_ptr(), cs_v.data_ptr(), in_h, in_w,
            off, gx.shape[1], g0, int(fy0), int(fx0), img_h, img_w, window,
            1.0 / (window * window), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "hs_sweeps", rc)
    return u_out, v_out


def hs_wide_sweeps(u, v, gx, gy, gt, inv_denom, window, fuse):
    """``fuse`` whole-frame sweeps of the wide form (arguments as
    :func:`hs_sweeps_plain`'s), two launches each: column sums of u and v
    to scratch, then the row sums and the update."""
    global LAUNCHES
    h, w = u.shape
    for _ in range(fuse):
        u, v = _wide_launch(u, v, gx, gy, gt, inv_denom, (h, w), 0, 0, 0, 0,
                            h, w, window)
        LAUNCHES += 2
    return u, v


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


def _inside_mask(row0: int, col0: int, hh: int, hw: int, img_h: int,
                 img_w: int, like: torch.Tensor) -> torch.Tensor:
    """1 where local cell (y, x) of a tile whose (0, 0) sits at frame
    coordinates (row0, col0) is inside the (img_h, img_w) frame, else 0."""
    ys = torch.arange(hh, device=like.device) + row0
    xs = torch.arange(hw, device=like.device) + col0
    return (((ys >= 0) & (ys < img_h))[:, None]
            & ((xs >= 0) & (xs < img_w))[None, :]).to(like.dtype)


def hs_tile_sweeps_plain(u_p, v_p, gx_p, gy_p, gt_p, inv_p, row0: int,
                         col0: int, img_h: int, img_w: int, window: int,
                         fuse: int):
    """``fuse`` HS sweeps on one halo'd tile, in plain PyTorch: tpuflow's
    ``_hs_sweeps`` under its inside mask (u, v zeroed outside the frame
    at load and after every sweep), valid regions shrinking by r per
    sweep. Returns the (hh - 2*fuse*r, hw - 2*fuse*r) core."""
    hh, hw = u_p.shape
    r = window // 2
    inv_area = 1.0 / (window * window)
    mask = _inside_mask(row0, col0, hh, hw, img_h, img_w, u_p)
    u = u_p * mask
    v = v_p * mask
    for t in range(fuse):
        o = r * (t + 1)
        core = (slice(o, hh - o), slice(o, hw - o))
        ub = _box_sum_valid(u, window) * inv_area
        vb = _box_sum_valid(v, window) * inv_area
        gxc, gyc = gx_p[core], gy_p[core]
        upd = (gxc * ub + gyc * vb + gt_p[core]) * inv_p[core]
        u = (ub - gxc * upd) * mask[core]
        v = (vb - gyc * upd) * mask[core]
    return u, v


def hs_tile_sweeps(u_p, v_p, gx_p, gy_p, gt_p, inv_p, row0: int, col0: int,
                   img_h: int, img_w: int, window: int = 5, fuse: int = 1):
    """``fuse`` HS sweeps on one halo'd tile; returns its (th, tw) core.

    The six fields are (th + 2*fuse*r, tw + 2*fuse*r) with halos already
    exchanged; (row0, col0) are the frame coordinates of their (0, 0) in an
    (img_h, img_w) frame. CPU tensors take :func:`hs_tile_sweeps_plain`;
    CUDA tensors (contiguous float32) ceil(fuse / max_fuse(window))
    launches of the tile kernel of ``csrc/hs_stencil.cu``, each taking the
    last one's core, or at a window of 65 or more 2 * fuse launches of the
    wide form (:func:`hs_wide_tile_sweeps`), or raise. A tile with no core
    inside its halo raises on every device.
    """
    _build.check_fields("hs_tile_sweeps", u_p, v_p, gx_p, gy_p, gt_p, inv_p)
    if window < 1 or window % 2 == 0 or fuse < 1:
        raise ValueError(f"hs_tile_sweeps: need an odd window and fuse >= 1, "
                         f"got window={window}, fuse={fuse}")
    hh, hw = u_p.shape
    need = fuse * (window // 2)
    if hh <= 2 * need or hw <= 2 * need:
        raise ValueError(f"hs_tile_sweeps: a {hh}x{hw} tile has no core "
                         f"inside a {need}-pixel halo")
    if u_p.device.type == "cpu":
        return hs_tile_sweeps_plain(u_p, v_p, gx_p, gy_p, gt_p, inv_p, row0,
                                    col0, img_h, img_w, window, fuse)
    if not max_fuse(window):
        return hs_wide_tile_sweeps(u_p, v_p, gx_p, gy_p, gt_p, inv_p, row0,
                                   col0, img_h, img_w, window, fuse)
    return _split_tile(_tile_launch, u_p, v_p, gx_p, gy_p, gt_p, inv_p, row0,
                       col0, img_h, img_w, window, fuse)


def hs_wide_tile_sweeps(u_p, v_p, gx_p, gy_p, gt_p, inv_p, row0, col0, img_h,
                        img_w, window, fuse):
    """``fuse`` sweeps of the wide form on one halo'd tile (arguments as
    :func:`hs_tile_sweeps_plain`'s), two launches each: sweep t takes the
    last one's result, r cells smaller on each side, and reads the fixed
    fields t*r cells in, where its output starts."""
    global LAUNCHES_TILE
    r = window // 2
    u, v = u_p, v_p
    for t in range(1, fuse + 1):
        o = (t - 1) * r
        u, v = _wide_launch(u, v, gx_p, gy_p, gt_p, inv_p,
                            (u.shape[0] - 2 * r, u.shape[1] - 2 * r), r,
                            t * r, row0 + o, col0 + o, img_h, img_w, window)
        LAUNCHES_TILE += 2
    return u, v


def _split_tile(launch, u_p, v_p, gx_p, gy_p, gt_p, inv_p, row0, col0, img_h,
                img_w, window, fuse, f_max=None):
    """``fuse`` sweeps on one halo'd tile as ceil(fuse / f_max) calls of
    ``launch``, which takes :func:`hs_tile_sweeps_plain`'s arguments and
    runs at most ``f_max`` sweeps (default: :func:`max_fuse` of
    ``window``): each call takes the last one's core, its origin moved in
    by r per sweep run so far."""
    return _build.split_fuse(
        lambda u, v, fixed, off, k: launch(u, v, *fixed, row0 + off,
                                           col0 + off, img_h, img_w, window,
                                           k),
        u_p, v_p, fuse, f_max or max_fuse(window), (gx_p, gy_p, gt_p, inv_p),
        step=window // 2)


def _tile_launch(u_p, v_p, gx_p, gy_p, gt_p, inv_p, row0, col0, img_h, img_w,
                 window, fuse):
    """One launch of hs_tile_kernel (arguments as
    :func:`hs_tile_sweeps_plain`'s); returns the core."""
    global LAUNCHES_TILE
    tile_for(window, fuse)
    lib = _lib()
    hh, hw = u_p.shape
    need = fuse * (window // 2)
    u_out = u_p.new_empty((hh - 2 * need, hw - 2 * need))
    v_out = torch.empty_like(u_out)
    with torch.cuda.device(u_p.device):
        rc = lib.hs_tile_launch(
            u_p.data_ptr(), v_p.data_ptr(), gx_p.data_ptr(), gy_p.data_ptr(),
            gt_p.data_ptr(), inv_p.data_ptr(), u_out.data_ptr(),
            v_out.data_ptr(), hh, hw, int(row0), int(col0), img_h, img_w,
            window, fuse, 1.0 / (window * window),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "hs_sweeps", rc)
    LAUNCHES_TILE += 1
    return u_out, v_out


def horn_schunck_resident_plain(prev, next, window_size: int = 5,
                                max_iterations: int = 100,
                                alpha: float = 1.0):
    """:func:`horn_schunck_resident` in plain PyTorch: zero start, each
    sweep dividing by alpha^2 + gx^2 + gy^2 (``_hs_resident_kernel``)."""
    from tpuflow_torch.solvers.horn_schunck import hs_gradients

    gx, gy, gt = hs_gradients(prev, next)
    inv_area = 1.0 / (window_size * window_size)
    u = torch.zeros_like(gt)
    v = torch.zeros_like(gt)
    for _ in range(max_iterations):
        ub = _box_sum(u, window_size) * inv_area
        vb = _box_sum(v, window_size) * inv_area
        upd = (gx * ub + gy * vb + gt) / (alpha * alpha + gx * gx + gy * gy)
        u = ub - gx * upd
        v = vb - gy * upd
    return u, v


def horn_schunck_resident2_plain(prev, next, window_size: int = 5,
                                 max_iterations: int = 100,
                                 alpha: float = 1.0):
    """:func:`horn_schunck_resident2` in plain PyTorch: the reciprocal
    1 / (alpha^2 + gx^2 + gy^2) once, then the sweeps of
    :func:`hs_sweeps_plain` (``_hs_resident2_kernel``)."""
    from tpuflow_torch.solvers.horn_schunck import hs_gradients

    gx, gy, gt = hs_gradients(prev, next)
    inv = 1.0 / (alpha * alpha + gx * gx + gy * gy)
    u = torch.zeros_like(gt)
    return hs_sweeps_plain(u, u, gx, gy, gt, inv, window_size,
                           max_iterations)


def resident_plan(window: int, iterations: int) -> tuple[int, int]:
    """(fuse, groups) of one resident solve: up to ``fuse`` sweeps between
    two grid syncs (:data:`RESIDENT_FUSE`, or fewer where the staged tile
    holds fewer), ceil(iterations / fuse) groups, the last one the rest.
    fuse 0 is the wide form (a window of 65 or more), one sweep a group.
    Every group swaps the two (u, v) buffers."""
    fuse = min(RESIDENT_FUSE, max_fuse(window))
    return fuse, -(-iterations // fuse) if fuse else iterations


def _resident(prev, next, window_size, max_iterations, alpha, recip):
    global LAUNCHES_RESIDENT, LAUNCHES_RESIDENT2
    from tpuflow_torch.solvers.horn_schunck import hs_gradients

    name = "horn_schunck_resident2" if recip else "horn_schunck_resident"
    if window_size < 1 or window_size % 2 == 0 or max_iterations < 0:
        raise ValueError(f"{name}: need an odd window and max_iterations "
                         f">= 0, got {window_size}, {max_iterations}")
    _build.check_fields(name, prev, next)
    if prev.device.type == "cpu":
        plain = (horn_schunck_resident2_plain if recip
                 else horn_schunck_resident_plain)
        return plain(prev, next, window_size, max_iterations, alpha)
    gx, gy, gt = hs_gradients(prev, next)
    h, w = gx.shape
    fuse, groups = resident_plan(window_size, max_iterations)
    lib = _lib_resident()
    u0, v0, u1, v1 = (torch.empty_like(gx) for _ in range(4))
    inv = torch.empty_like(gx) if recip else None
    cs = [torch.empty_like(gx) for _ in range(2)] if not fuse else [None] * 2
    grid = ctypes.c_int(0)
    with torch.cuda.device(gx.device):
        rc = lib.hs_resident_launch(
            gx.data_ptr(), gy.data_ptr(), gt.data_ptr(),
            None if inv is None else inv.data_ptr(), u0.data_ptr(),
            v0.data_ptr(), u1.data_ptr(), v1.data_ptr(),
            *(None if c is None else c.data_ptr() for c in cs), h, w,
            window_size, max_iterations, fuse, float(alpha * alpha),
            1.0 / (window_size * window_size), int(recip),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(grid))
    _build.check_launch(lib, "hs_resident", rc)
    if recip:
        LAUNCHES_RESIDENT2 += 1
    else:
        LAUNCHES_RESIDENT += 1
    return (u0, v0) if groups % 2 == 0 else (u1, v1)


def horn_schunck_resident(prev: torch.Tensor, next: torch.Tensor,
                          window_size: int = 5, max_iterations: int = 100,
                          alpha: float = 1.0):
    """Horn-Schunck with the whole solve in one kernel launch (tpuflow's
    ``horn_schunck_pallas_resident``); returns (u, v).

    Gradients by :func:`tpuflow_torch.solvers.hs_gradients`, then zero
    (u, v) and ``max_iterations`` sweeps dividing by alpha^2 + gx^2 + gy^2
    every sweep. CPU tensors take :func:`horn_schunck_resident_plain`;
    CUDA tensors (contiguous float32) one cooperative launch of
    ``csrc/hs_resident.cu`` at any odd window (:func:`resident_plan`), or
    raise.
    """
    return _resident(prev, next, window_size, max_iterations, alpha, False)


def horn_schunck_resident2(prev: torch.Tensor, next: torch.Tensor,
                           window_size: int = 5, max_iterations: int = 100,
                           alpha: float = 1.0):
    """:func:`horn_schunck_resident` with the reciprocal of the
    denominator computed once (tpuflow's ``horn_schunck_pallas_resident2``):
    the same sweeps as :func:`horn_schunck_fused`. CPU tensors take
    :func:`horn_schunck_resident2_plain`."""
    return _resident(prev, next, window_size, max_iterations, alpha, True)
