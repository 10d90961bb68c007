"""Fused Black-Anandan IRLS Jacobi sweeps: the CUDA kernel and its plain version.

Counterpart of ``tpuflow/kernels/irls_stencil.py::irls_sweep_pallas``. One
reference sweep (IRLS_OpticalFlow_Pyramid, OpticalFlow.cpp:213-270)
updates every site with

    dEx = lambdaD * gx * psi_GM(gx*u + gy*v + it, sigmaD)
        + lambdaS * sum_{4-nbr in frame} psi_GM(u - u_nbr, sigmaS)
    u  -= dEx / sup_x       (sup = Lipschitz bound, a global scalar)

in Jacobi order. :func:`irls_sweeps` runs ``fuse`` sweeps: on a CUDA
tensor through ``csrc/irls_stencil.cu`` (one launch of at most
:data:`MAX_FUSE` sweeps, a deeper block as several; the source says what
bounds it on the H100 and how its design answers: each edge's term
computed once and added, negated, at the far end, which is bitwise the
plain version's per-neighbour sum since the term is antisymmetric to the
last bit), on a CPU tensor through :func:`irls_sweeps_plain`.
``sup_x``/``sup_y`` are one-element tensors on the fields' device, so a
launch never waits for the host.
Energy checks and early stopping stay outside
(:mod:`tpuflow_torch.solvers.black_anandan_fast`).

:func:`irls_tile_sweeps` is ``irls_tile_sweeps``, the tile body of the
sharded IRLS level (:mod:`tpuflow_torch.dist.solvers`): the same sweeps
on one halo'd tile at a frame offset, through the same CUDA source and
sweep body.

:func:`irls_gated_sweeps` is the flagship refinement's sweep
(``irls_gated_sweep_pallas``, OpticalFlow_BlockMatching.cpp:465-514): the
same update with each neighbour term gated by same-region labels and
weighted by the direction coherence 0.5 * (1 + cos(u, u_nbr)), batched
over reference directions; CUDA tensors take ``csrc/irls_gated.cu``, which
computes each edge's term once in the same way.

:func:`irls_gated_energy` is the gated refine's energy check (the
plain jnp energy of tpuflow's ``irls_gradient_method``; no TPU kernel):
CUDA tensors take ``gated_energy_kernel`` of ``csrc/irls_gated.cu``, one
launch a check, whose float32 terms are the plain version's to the last
bit and whose float64 sum runs in a fixed order.

:func:`irls_gated_tile_sweeps` is the same gated sweep on one halo'd
mesh tile at a frame origin (tpuflow's ``_irls_sweeps_gated`` on the
tiles of ``tpuflow/dist/bm_refine.py``), through the tile form of
``csrc/irls_gated.cu``; its plain version is
:func:`irls_gated_tile_sweeps_plain`.

A block of sweeps deeper than one launch takes runs as several launches
(:func:`tpuflow_torch.kernels._build.split_fuse`): the sweeps are
sequential, so the result is bitwise that of one.
"""

from __future__ import annotations

import ctypes

import torch

from tpuflow_torch.core import borders as bd
from tpuflow_torch.kernels import _build

# Launches of the CUDA kernels in this process (never the plain versions):
# irls_sweeps, irls_tile_sweeps, irls_gated_sweeps, irls_gated_tile_sweeps
# and irls_gated_energy.
LAUNCHES = 0
LAUNCHES_TILE = 0
LAUNCHES_GATED = 0
LAUNCHES_GATED_TILE = 0
LAUNCHES_GATED_ENERGY = 0
# The staged tiles (rows, columns) and threads per block of
# csrc/irls_stencil.cu (irls_sweeps and irls_tile_sweeps: WIDE, and
# NARROW, which its launcher takes where WIDE's blocks would fill a
# fraction of the card) and of csrc/irls_gated.cu, as the sources compile
# them: u, v and the four edge terms of the tile in shared memory (6 float
# fields), the frame or gate bits in the threads' registers. A block
# writes the tile less a fuse-pixel halo on each side. Chosen by timing
# staged tiles on the H100 (PERF.md; scripts/irls_stage_variants.py).
STAGE = (72, 128)
THREADS = 768
NARROW_STAGE = (64, 64)
NARROW_THREADS = 1024
GATED_STAGE = (72, 128)
GATED_THREADS = 768
# The most sweeps one launch takes: the deepest fuse that leaves a core
# (WIDE's: the launcher takes NARROW only where it leaves one).
MAX_FUSE = _build.max_halo(STAGE)
GATED_MAX_FUSE = _build.max_halo(GATED_STAGE)

# Neighbour offsets (dx, dy), in the order the terms are summed.
NEIGHBORS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    csrc/irls_stencil.cu."""
    lib.irls_sweeps_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4
        + [ctypes.c_void_p])
    lib.irls_sweeps_launch.restype = ctypes.c_int
    lib.irls_tile_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float] * 4
        + [ctypes.c_void_p])
    lib.irls_tile_launch.restype = ctypes.c_int
    lib.irls_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.irls_blocks_per_sm.restype = ctypes.c_int
    lib.irls_sweeps_error_string.argtypes = [ctypes.c_int]
    lib.irls_sweeps_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    return _bind(_build.load("irls_stencil"))


def stage_core(fuse: int) -> tuple[int, int]:
    """The core one block of csrc/irls_stencil.cu on its WIDE stage writes
    at ``fuse``. Raises if nothing is left (beyond :data:`MAX_FUSE`)."""
    return _build.core("irls_sweeps", STAGE, fuse)


def smem_bytes(fuse: int) -> int:
    """u, v and the four edge terms of the WIDE staged tile: the same at
    every fuse :func:`stage_core` accepts."""
    stage_core(fuse)
    return 6 * 4 * STAGE[0] * STAGE[1]


def blocks_per_sm(tile: bool, narrow: bool = False) -> int:
    """Blocks of the sweeps (``tile`` False) or the tile kernel on the WIDE
    or the NARROW stage one SM of the current card holds at once (CUDA's
    occupancy calculator)."""
    lib = _lib()
    n = lib.irls_blocks_per_sm(int(tile), int(narrow))
    _build.check_launch(lib, "irls_sweeps", -n if n < 0 else 0)
    return n


def neighbor_masks(row0: int, col0: int, hh: int, hw: int, img_h: int,
                   img_w: int, device) -> list[torch.Tensor]:
    """For each of :data:`NEIGHBORS`, where that neighbour of the cells of
    an (hh, hw) tile whose (0, 0) sits at frame coordinates (row0, col0)
    is inside the (img_h, img_w) frame (tpuflow's ``_nb_masks``)."""
    ys = torch.arange(hh, device=device)[:, None] + row0
    xs = torch.arange(hw, device=device)[None, :] + col0
    return [(ys + dy >= 0) & (ys + dy < img_h) & (xs + dx >= 0)
            & (xs + dx < img_w) for dx, dy in NEIGHBORS]


def irls_sweeps_plain(u, v, gx, gy, it, sup_x, sup_y, fuse: int,
                      lambda_d: float, lambda_s: float,
                      sigma_d: float, sigma_s: float):
    """``fuse`` IRLS Jacobi sweeps in plain PyTorch; returns (u, v)."""
    from tpuflow_torch.solvers.mestimators import geman_mcclure_psi as psi

    h, w = u.shape
    masks = neighbor_masks(0, 0, h, w, h, w, u.device)
    for _ in range(fuse):
        psi_d = psi(gx * u + gy * v + it, sigma_d)
        up = bd.pad2d(u, 1, bd.ZERO)
        vp = bd.pad2d(v, 1, bd.ZERO)
        nx = torch.zeros_like(u)
        ny = torch.zeros_like(v)
        for (dx, dy), m in zip(NEIGHBORS, masks):
            un = up[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            vn = vp[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            nx = nx + torch.where(m, psi(u - un, sigma_s), 0.0)
            ny = ny + torch.where(m, psi(v - vn, sigma_s), 0.0)
        u, v = (u - (lambda_d * gx * psi_d + lambda_s * nx) / sup_x,
                v - (lambda_d * gy * psi_d + lambda_s * ny) / sup_y)
    return u, v


def irls_sweeps(u, v, gx, gy, it, sup_x, sup_y, fuse: int,
                lambda_d: float = 5.0, lambda_s: float = 1.0,
                sigma_d: float = 0.1, sigma_s: float = 0.1):
    """``fuse`` IRLS Jacobi sweeps; returns new (u, v).

    CPU tensors take :func:`irls_sweeps_plain`; CUDA tensors (contiguous
    float32 fields of one shape, one-element float32 ``sup_x``/``sup_y``
    on the same device) take ceil(fuse / MAX_FUSE) launches of the CUDA
    kernel (one up to :data:`MAX_FUSE`), or raise.
    """
    _build.check_fields("irls_sweeps", u, v, gx, gy, it)
    if fuse < 1:
        raise ValueError(f"irls_sweeps: need fuse >= 1, got {fuse}")
    _check_sups("irls_sweeps", u, sup_x, sup_y)
    consts = (lambda_d, lambda_s, sigma_d, sigma_s)
    if u.device.type == "cpu":
        return irls_sweeps_plain(u, v, gx, gy, it, sup_x, sup_y, fuse,
                                 *consts)
    return _split_sweeps(_sweeps_launch, u, v, gx, gy, it, sup_x, sup_y, fuse,
                         *consts)


def _split_sweeps(launch, u, v, gx, gy, it, sup_x, sup_y, fuse, *consts,
                  f_max=MAX_FUSE):
    """``fuse`` sweeps as ceil(fuse / f_max) calls of ``launch``, which
    takes :func:`irls_sweeps_plain`'s arguments and runs at most ``f_max``
    sweeps."""
    return _build.split_fuse(
        lambda u, v, fixed, off, k: launch(u, v, *fixed, sup_x, sup_y, k,
                                           *consts),
        u, v, fuse, f_max, (gx, gy, it))


def _sweeps_launch(u, v, gx, gy, it, sup_x, sup_y, fuse, lambda_d, lambda_s,
                   sigma_d, sigma_s):
    """One launch of irls_sweeps_kernel (arguments as
    :func:`irls_sweeps_plain`'s)."""
    global LAUNCHES
    stage_core(fuse)
    lib = _lib()
    h, w = u.shape
    u_out = torch.empty_like(u)
    v_out = torch.empty_like(v)
    with torch.cuda.device(u.device):
        rc = lib.irls_sweeps_launch(
            u.data_ptr(), v.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            it.data_ptr(), sup_x.data_ptr(), sup_y.data_ptr(),
            u_out.data_ptr(), v_out.data_ptr(), h, w, fuse, lambda_d,
            lambda_s, sigma_d, sigma_s,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "irls_sweeps", rc)
    LAUNCHES += 1
    return u_out, v_out


def _check_sups(name, u, sup_x, sup_y):
    for s in (sup_x, sup_y):
        if s.numel() != 1 or s.device != u.device:
            raise ValueError(f"{name}: sup_x/sup_y must be one-element "
                             f"tensors on {u.device}")
    if u.device.type != "cpu" and (sup_x.dtype != torch.float32
                                   or sup_y.dtype != torch.float32):
        raise TypeError(f"{name}: the CUDA kernel takes float32 sup_x/sup_y")


def irls_tile_sweeps_plain(u_p, v_p, gx_p, gy_p, it_p, sup_x, sup_y,
                           row0: int, col0: int, img_h: int, img_w: int,
                           fuse: int, lambda_d: float, lambda_s: float,
                           sigma_d: float, sigma_s: float):
    """``fuse`` IRLS sweeps on one halo'd tile in plain PyTorch: tpuflow's
    ``_irls_sweeps`` with neighbour masks from frame coordinates
    (``_nb_masks``), valid regions shrinking by one pixel per sweep, u and
    v not re-zeroed. Returns the (hh - 2*fuse, hw - 2*fuse) core."""
    from tpuflow_torch.solvers.mestimators import geman_mcclure_psi as psi

    hh, hw = u_p.shape
    masks = neighbor_masks(row0, col0, hh, hw, img_h, img_w, u_p.device)
    u, v = u_p, v_p
    for t in range(fuse):
        sh, sw = hh - 2 * t, hw - 2 * t
        uc = u[1 : sh - 1, 1 : sw - 1]
        vc = v[1 : sh - 1, 1 : sw - 1]
        o = t + 1
        core = (slice(o, o + sh - 2), slice(o, o + sw - 2))
        gxc, gyc = gx_p[core], gy_p[core]
        psi_d = psi(gxc * uc + gyc * vc + it_p[core], sigma_d)
        nx = torch.zeros_like(uc)
        ny = torch.zeros_like(vc)
        for (dx, dy), m in zip(NEIGHBORS, masks):
            un = u[1 + dy : sh - 1 + dy, 1 + dx : sw - 1 + dx]
            vn = v[1 + dy : sh - 1 + dy, 1 + dx : sw - 1 + dx]
            nx = nx + torch.where(m[core], psi(uc - un, sigma_s), 0.0)
            ny = ny + torch.where(m[core], psi(vc - vn, sigma_s), 0.0)
        u, v = (uc - (lambda_d * gxc * psi_d + lambda_s * nx) / sup_x,
                vc - (lambda_d * gyc * psi_d + lambda_s * ny) / sup_y)
    return u, v


def irls_tile_sweeps(u_p, v_p, gx_p, gy_p, it_p, sup_x, sup_y, row0: int,
                     col0: int, img_h: int, img_w: int, fuse: int,
                     lambda_d: float = 5.0, lambda_s: float = 1.0,
                     sigma_d: float = 0.1, sigma_s: float = 0.1):
    """``fuse`` IRLS sweeps on one halo'd tile; returns its (th, tw) core.

    The five fields are (th + 2*fuse, tw + 2*fuse) with halos already
    exchanged; (row0, col0) are the frame coordinates of their (0, 0) in an
    (img_h, img_w) frame, and the core must lie in the frame (as a mesh
    tile does). CPU tensors take :func:`irls_tile_sweeps_plain`; CUDA
    tensors (contiguous float32, one-element float32 ``sup_x``/``sup_y``
    on the same device) ceil(fuse / MAX_FUSE) launches of the tile kernel
    of ``csrc/irls_stencil.cu``, each taking the last one's core, or raise.
    """
    _build.check_fields("irls_tile_sweeps", u_p, v_p, gx_p, gy_p, it_p)
    if fuse < 1:
        raise ValueError(f"irls_tile_sweeps: need fuse >= 1, got {fuse}")
    _check_sups("irls_tile_sweeps", u_p, sup_x, sup_y)
    hh, hw = u_p.shape
    th, tw = hh - 2 * fuse, hw - 2 * fuse
    if th < 1 or tw < 1:
        raise ValueError(f"irls_tile_sweeps: a {hh}x{hw} tile has no core "
                         f"inside a {fuse}-pixel halo")
    if (row0 + fuse < 0 or col0 + fuse < 0 or row0 + fuse + th > img_h
            or col0 + fuse + tw > img_w):
        raise ValueError(f"irls_tile_sweeps: the core at ({row0 + fuse}, "
                         f"{col0 + fuse}) leaves the {img_h}x{img_w} frame")
    consts = (lambda_d, lambda_s, sigma_d, sigma_s)
    if u_p.device.type == "cpu":
        return irls_tile_sweeps_plain(u_p, v_p, gx_p, gy_p, it_p, sup_x,
                                      sup_y, row0, col0, img_h, img_w, fuse,
                                      *consts)
    return _split_tile(_tile_launch, u_p, v_p, gx_p, gy_p, it_p, sup_x, sup_y,
                       row0, col0, img_h, img_w, fuse, *consts)


def _split_tile(launch, u_p, v_p, gx_p, gy_p, it_p, sup_x, sup_y, row0, col0,
                img_h, img_w, fuse, *consts, f_max=MAX_FUSE):
    """``fuse`` sweeps on one halo'd tile as ceil(fuse / f_max) calls of
    ``launch``, which takes :func:`irls_tile_sweeps_plain`'s arguments and
    runs at most ``f_max`` sweeps: each call takes the last one's core,
    its origin moved in by the sweeps run so far."""
    return _build.split_fuse(
        lambda u, v, fixed, off, k: launch(
            u, v, *fixed, sup_x, sup_y, row0 + off, col0 + off, img_h, img_w,
            k, *consts),
        u_p, v_p, fuse, f_max, (gx_p, gy_p, it_p), step=1)


def _tile_launch(u_p, v_p, gx_p, gy_p, it_p, sup_x, sup_y, row0, col0,
                 img_h, img_w, fuse, lambda_d, lambda_s, sigma_d, sigma_s):
    """One launch of irls_tile_kernel (arguments as
    :func:`irls_tile_sweeps_plain`'s); returns the core."""
    global LAUNCHES_TILE
    stage_core(fuse)
    lib = _lib()
    hh, hw = u_p.shape
    u_out = u_p.new_empty((hh - 2 * fuse, hw - 2 * fuse))
    v_out = torch.empty_like(u_out)
    with torch.cuda.device(u_p.device):
        rc = lib.irls_tile_launch(
            u_p.data_ptr(), v_p.data_ptr(), gx_p.data_ptr(), gy_p.data_ptr(),
            it_p.data_ptr(), sup_x.data_ptr(), sup_y.data_ptr(),
            u_out.data_ptr(), v_out.data_ptr(), hh, hw, int(row0), int(col0),
            img_h, img_w, fuse, lambda_d, lambda_s, sigma_d, sigma_s,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "irls_sweeps", rc)
    LAUNCHES_TILE += 1
    return u_out, v_out


def _lib_gated() -> ctypes.CDLL:
    lib = _build.load("irls_gated")
    lib.irls_gated_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
        + [ctypes.c_void_p])
    lib.irls_gated_launch.restype = ctypes.c_int
    lib.irls_gated_tile_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float] * 4
        + [ctypes.c_void_p])
    lib.irls_gated_tile_launch.restype = ctypes.c_int
    lib.irls_gated_energy_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    lib.irls_gated_energy_launch.restype = ctypes.c_int
    lib.irls_gated_energy_span.argtypes = []
    lib.irls_gated_energy_span.restype = ctypes.c_int
    lib.irls_gated_blocks_per_sm.argtypes = []
    lib.irls_gated_blocks_per_sm.restype = ctypes.c_int
    lib.irls_gated_error_string.argtypes = [ctypes.c_int]
    lib.irls_gated_error_string.restype = ctypes.c_char_p
    return lib


def gated_core(fuse: int) -> tuple[int, int]:
    """The core one block of the gated kernel writes at ``fuse``. Raises
    if nothing is left (beyond :data:`GATED_MAX_FUSE`)."""
    return _build.core("irls_gated_sweeps", GATED_STAGE, fuse)


def smem_bytes_gated(fuse: int) -> int:
    """u, v and the four edge terms of the staged tile: the same at every
    fuse :func:`gated_core` accepts."""
    gated_core(fuse)
    return 6 * 4 * GATED_STAGE[0] * GATED_STAGE[1]


def blocks_per_sm_gated() -> int:
    """Blocks of the gated kernel one SM of the current card holds at once
    (CUDA's occupancy calculator)."""
    lib = _lib_gated()
    n = lib.irls_gated_blocks_per_sm()
    _build.check_launch(lib, "irls_gated", -n if n < 0 else 0)
    return n


def irls_gated_sweeps_plain(u, v, gx, gy, it, labels, sup_x, sup_y,
                            fuse: int, lambda_d: float, lambda_s: float,
                            sigma_d: float, sigma_s: float):
    """``fuse`` region-gated IRLS Jacobi sweeps in plain PyTorch (the body
    of tpuflow's ``irls_gradient_method``); returns (u, v). ``u``, ``v``,
    ``it`` may carry a leading batch axis; ``gx``, ``gy``, ``labels`` are
    (H, W) and shared."""
    from tpuflow_torch.solvers.bm_flow import _neighbor_terms, _region_gates
    from tpuflow_torch.solvers.mestimators import geman_mcclure_psi as psi

    gates = _region_gates(labels, u.dtype)
    for _ in range(fuse):
        psi_d = psi(gx * u + gy * v + it, sigma_d)
        nx, ny = _neighbor_terms(u, v, labels, sigma_s, gates)
        u, v = (u - (lambda_d * gx * psi_d + lambda_s * nx) / sup_x,
                v - (lambda_d * gy * psi_d + lambda_s * ny) / sup_y)
    return u, v


def irls_gated_sweeps(u, v, gx, gy, it, labels, sup_x, sup_y, fuse: int,
                      lambda_d: float, lambda_s: float,
                      sigma_d: float, sigma_s: float):
    """``fuse`` region-gated IRLS Jacobi sweeps; returns new (u, v).

    ``u``, ``v``, ``it``: (H, W) or (B, H, W), one field per reference
    direction; ``gx``, ``gy``, ``labels``: (H, W), shared. CPU tensors take
    :func:`irls_gated_sweeps_plain`; CUDA tensors (contiguous float32
    fields, int32 labels, one-element float32 ``sup_x``/``sup_y`` on the
    same device) take ceil(fuse / GATED_MAX_FUSE) launches of the CUDA
    kernel, or raise.
    """
    if u.shape != v.shape or u.shape != it.shape or u.dim() not in (2, 3):
        raise ValueError("irls_gated_sweeps: u, v, it must share an (H, W) "
                         f"or (B, H, W) shape, got {tuple(u.shape)}, "
                         f"{tuple(v.shape)}, {tuple(it.shape)}")
    _build.check_fields("irls_gated_sweeps", gx, gy)
    if (labels.shape != gx.shape or u.shape[-2:] != gx.shape
            or labels.device != gx.device):
        raise ValueError("irls_gated_sweeps: labels and the fields' (H, W) "
                         "must match gx on its device")
    if fuse < 1:
        raise ValueError(f"irls_gated_sweeps: need fuse >= 1, got {fuse}")
    _check_sups("irls_gated_sweeps", u, sup_x, sup_y)
    if u.device.type == "cpu":
        return irls_gated_sweeps_plain(u, v, gx, gy, it, labels, sup_x,
                                       sup_y, fuse, lambda_d, lambda_s,
                                       sigma_d, sigma_s)
    for f in (u, v, it, gx, gy, sup_x, sup_y):
        if f.device != gx.device or f.dtype != torch.float32:
            raise TypeError("irls_gated_sweeps: the CUDA kernel takes "
                            f"float32 on {gx.device}, got {f.dtype} on "
                            f"{f.device}")
        if not f.is_contiguous():
            raise ValueError("irls_gated_sweeps: the CUDA kernel takes "
                             "contiguous fields")
    if labels.dtype != torch.int32 or not labels.is_contiguous():
        raise TypeError("irls_gated_sweeps: the CUDA kernel takes contiguous "
                        f"int32 labels, got {labels.dtype}")
    return _split_gated(_gated_launch, u, v, gx, gy, it, labels, sup_x, sup_y,
                        fuse, lambda_d, lambda_s, sigma_d, sigma_s)


def _split_gated(launch, u, v, gx, gy, it, labels, sup_x, sup_y, fuse,
                 *consts, f_max=GATED_MAX_FUSE):
    """``fuse`` gated sweeps as ceil(fuse / f_max) calls of ``launch``,
    which takes :func:`irls_gated_sweeps_plain`'s arguments and runs at
    most ``f_max`` sweeps."""
    return _build.split_fuse(
        lambda u, v, fixed, off, k: launch(u, v, *fixed, sup_x, sup_y, k,
                                           *consts),
        u, v, fuse, f_max, (gx, gy, it, labels))


def _gated_launch(u, v, gx, gy, it, labels, sup_x, sup_y, fuse, lambda_d,
                  lambda_s, sigma_d, sigma_s):
    """One launch of irls_gated_kernel (arguments as
    :func:`irls_gated_sweeps_plain`'s)."""
    global LAUNCHES_GATED
    gated_core(fuse)
    lib = _lib_gated()
    h, w = gx.shape
    batch = u.shape[0] if u.dim() == 3 else 1
    u_out = torch.empty_like(u)
    v_out = torch.empty_like(v)
    with torch.cuda.device(u.device):
        rc = lib.irls_gated_launch(
            u.data_ptr(), v.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            it.data_ptr(), labels.data_ptr(), sup_x.data_ptr(),
            sup_y.data_ptr(), u_out.data_ptr(), v_out.data_ptr(), h, w,
            batch, fuse, lambda_d, lambda_s, sigma_d, sigma_s,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "irls_gated", rc)
    LAUNCHES_GATED += 1
    return u_out, v_out


def irls_gated_energy_plain(u, v, gx, gy, it, labels, lambda_d: float,
                            lambda_s: float, sigma_d: float, sigma_s: float):
    """The gated refine's total energy per field in plain PyTorch
    (tpuflow's ``irls_gradient_method`` energy): float64, over the last two
    axes, the sum taken in float64 so the stop decision does not hang on
    one device's reduction order. ``u``, ``v``, ``it`` may carry a leading
    batch axis; ``gx``, ``gy``, ``labels`` are (H, W) and shared."""
    from tpuflow_torch.solvers.bm_flow import _neighbor_energy
    from tpuflow_torch.solvers.mestimators import geman_mcclure_rho as rho

    center = rho(gx * u + gy * v + it, sigma_d)
    return torch.sum(lambda_d * center
                     + lambda_s * _neighbor_energy(u, v, labels, sigma_s),
                     dim=(-2, -1), dtype=torch.float64)


def irls_gated_energy(u, v, gx, gy, it, labels, lambda_d: float,
                      lambda_s: float, sigma_d: float, sigma_s: float):
    """The gated refine's total energy per field: a float64 tensor of
    ``u.shape[:-2]``.

    ``u``, ``v``, ``it``: (H, W) or (B, H, W), one field per reference
    direction; ``gx``, ``gy``, ``labels``: (H, W), shared; all on one
    device. CPU tensors take :func:`irls_gated_energy_plain`; CUDA tensors
    (contiguous float32 fields, contiguous int32 labels) one launch of
    ``gated_energy_kernel``, or raise. The kernel's float32 terms are the
    plain version's; its float64 sum runs in another order, fixed, so its
    E is the same bits from run to run.
    """
    global LAUNCHES_GATED_ENERGY
    if u.shape != v.shape or u.shape != it.shape or u.dim() not in (2, 3):
        raise ValueError("irls_gated_energy: u, v, it must share an (H, W) "
                         f"or (B, H, W) shape, got {tuple(u.shape)}, "
                         f"{tuple(v.shape)}, {tuple(it.shape)}")
    for f in (gx, gy, labels):
        if f.shape != u.shape[-2:]:
            raise ValueError("irls_gated_energy: gx, gy and labels must be "
                             f"the fields' (H, W) {tuple(u.shape[-2:])}, "
                             f"got {tuple(f.shape)}")
    for f in (v, gx, gy, it, labels):
        if f.device != u.device:
            raise ValueError(f"irls_gated_energy: tensors on {f.device} and "
                             f"{u.device}")
    consts = (lambda_d, lambda_s, sigma_d, sigma_s)
    if u.device.type == "cpu":
        return irls_gated_energy_plain(u, v, gx, gy, it, labels, *consts)
    for f in (u, v, gx, gy, it):
        if f.dtype != torch.float32:
            raise TypeError("irls_gated_energy: the CUDA kernel takes "
                            f"float32 fields, got {f.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError("irls_gated_energy: the CUDA kernel takes int32 "
                        f"labels, got {labels.dtype}")
    for f in (u, v, gx, gy, it, labels):
        if not f.is_contiguous():
            raise ValueError("irls_gated_energy: the CUDA kernel takes "
                             "contiguous tensors")
    if u.device.type != "cuda":
        raise ValueError(f"irls_gated_energy: no kernel for device "
                         f"{u.device}")
    lib = _lib_gated()
    h, w = gx.shape
    batch = u.shape[0] if u.dim() == 3 else 1
    span = lib.irls_gated_energy_span()
    n_partials = batch * -(-h * w // span)
    out = torch.empty(u.shape[:-2], dtype=torch.float64, device=u.device)
    partials = torch.empty(n_partials, dtype=torch.float64, device=u.device)
    with torch.cuda.device(u.device):
        rc = lib.irls_gated_energy_launch(
            u.data_ptr(), v.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            it.data_ptr(), labels.data_ptr(), partials.data_ptr(),
            n_partials, out.data_ptr(), h, w, batch, *consts,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "irls_gated", rc)
    LAUNCHES_GATED_ENERGY += 1
    return out


def irls_gated_tile_sweeps_plain(u_p, v_p, gx_p, gy_p, it_p, lab_p, sup_x,
                                 sup_y, row0: int, col0: int, img_h: int,
                                 img_w: int, fuse: int, lambda_d: float,
                                 lambda_s: float, sigma_d: float,
                                 sigma_s: float):
    """``fuse`` region-gated IRLS sweeps on one halo'd tile in plain
    PyTorch: tpuflow's ``_irls_sweeps_gated``, the neighbour gates from the
    tile's labels and the frame-edge masks of :func:`neighbor_masks` at
    frame origin (row0, col0), valid regions shrinking by one pixel a
    sweep. ``u_p``, ``v_p``, ``it_p``: (hh, hw) or (B, hh, hw);
    ``gx_p``, ``gy_p``, ``lab_p``: (hh, hw). Returns the core, ``fuse``
    cells in from each side."""
    from tpuflow_torch.solvers.mestimators import geman_mcclure_psi as psi
    from tpuflow_torch.utils.numerics import sqrt

    hh, hw = gx_p.shape
    masks = neighbor_masks(row0, col0, hh, hw, img_h, img_w, gx_p.device)
    lab_c = lab_p[1 : hh - 1, 1 : hw - 1]
    gates = [(m[1 : hh - 1, 1 : hw - 1]
              & (lab_p[1 + dy : hh - 1 + dy, 1 + dx : hw - 1 + dx] == lab_c))
             .to(u_p.dtype) for (dx, dy), m in zip(NEIGHBORS, masks)]
    u, v = u_p, v_p
    for t in range(fuse):
        sh, sw = hh - 2 * t, hw - 2 * t
        uc = u[..., 1 : sh - 1, 1 : sw - 1]
        vc = v[..., 1 : sh - 1, 1 : sw - 1]
        o = t + 1
        core = (slice(o, o + sh - 2), slice(o, o + sw - 2))
        gxc, gyc = gx_p[core], gy_p[core]
        psi_d = psi(gxc * uc + gyc * vc + it_p[(..., *core)], sigma_d)
        norm_f = sqrt(u * u + v * v)
        norm_c = norm_f[..., 1 : sh - 1, 1 : sw - 1]
        nx = torch.zeros_like(uc)
        ny = torch.zeros_like(vc)
        for (dx, dy), gate in zip(NEIGHBORS, gates):
            nb = (..., slice(1 + dy, sh - 1 + dy), slice(1 + dx, sw - 1 + dx))
            un, vn, nn = u[nb], v[nb], norm_f[nb]
            prod = norm_c * nn
            cosang = torch.where(
                prod > 0, (uc * un + vc * vn) / torch.clamp_min(prod, 1e-30),
                1.0)
            m = gate[t : t + sh - 2, t : t + sw - 2] * (0.5 * (1.0 + cosang))
            nx = nx + m * psi(uc - un, sigma_s)
            ny = ny + m * psi(vc - vn, sigma_s)
        u, v = (uc - (lambda_d * gxc * psi_d + lambda_s * nx) / sup_x,
                vc - (lambda_d * gyc * psi_d + lambda_s * ny) / sup_y)
    return u, v


def irls_gated_tile_sweeps(u_p, v_p, gx_p, gy_p, it_p, lab_p, sup_x, sup_y,
                           row0: int, col0: int, img_h: int, img_w: int,
                           fuse: int, lambda_d: float, lambda_s: float,
                           sigma_d: float, sigma_s: float):
    """``fuse`` region-gated IRLS sweeps on one halo'd tile; returns its
    core (``fuse`` cells in from each side).

    ``u_p``, ``v_p``, ``it_p``: (hh, hw) or (B, hh, hw), one field per
    reference direction; ``gx_p``, ``gy_p``, ``lab_p``: (hh, hw), shared;
    the halos hold the neighbouring tiles' values (real labels), and
    (row0, col0) are the frame coordinates of the arrays' (0, 0) in an
    (img_h, img_w) frame. CPU tensors take
    :func:`irls_gated_tile_sweeps_plain`; CUDA tensors (contiguous float32
    fields, int32 labels, one-element float32 ``sup_x``/``sup_y`` on the
    same device) ceil(fuse / GATED_MAX_FUSE) launches of the tile form of
    ``csrc/irls_gated.cu``, each taking the last one's core, or raise.
    """
    if u_p.shape != v_p.shape or u_p.shape != it_p.shape or u_p.dim() not in (
            2, 3):
        raise ValueError("irls_gated_tile_sweeps: u, v, it must share an "
                         f"(hh, hw) or (B, hh, hw) shape, got "
                         f"{tuple(u_p.shape)}, {tuple(v_p.shape)}, "
                         f"{tuple(it_p.shape)}")
    _build.check_fields("irls_gated_tile_sweeps", gx_p, gy_p)
    if (lab_p.shape != gx_p.shape or u_p.shape[-2:] != gx_p.shape
            or lab_p.device != gx_p.device):
        raise ValueError("irls_gated_tile_sweeps: labels and the fields' "
                         "(hh, hw) must match gx on its device")
    if fuse < 1:
        raise ValueError(f"irls_gated_tile_sweeps: need fuse >= 1, got {fuse}")
    _check_sups("irls_gated_tile_sweeps", u_p, sup_x, sup_y)
    hh, hw = gx_p.shape
    if hh - 2 * fuse < 1 or hw - 2 * fuse < 1:
        raise ValueError(f"irls_gated_tile_sweeps: a {hh}x{hw} tile has no "
                         f"core inside a {fuse}-pixel halo")
    consts = (lambda_d, lambda_s, sigma_d, sigma_s)
    if u_p.device.type == "cpu":
        return irls_gated_tile_sweeps_plain(u_p, v_p, gx_p, gy_p, it_p, lab_p,
                                            sup_x, sup_y, row0, col0, img_h,
                                            img_w, fuse, *consts)
    for f in (u_p, v_p, it_p, sup_x, sup_y):
        if f.device != gx_p.device or f.dtype != torch.float32:
            raise TypeError("irls_gated_tile_sweeps: the CUDA kernel takes "
                            f"float32 on {gx_p.device}, got {f.dtype} on "
                            f"{f.device}")
        if not f.is_contiguous():
            raise ValueError("irls_gated_tile_sweeps: the CUDA kernel takes "
                             "contiguous fields")
    if lab_p.dtype != torch.int32 or not lab_p.is_contiguous():
        raise TypeError("irls_gated_tile_sweeps: the CUDA kernel takes "
                        f"contiguous int32 labels, got {lab_p.dtype}")
    return _split_gated_tile(_gated_tile_launch, u_p, v_p, gx_p, gy_p, it_p,
                             lab_p, sup_x, sup_y, row0, col0, img_h, img_w,
                             fuse, *consts)


def _split_gated_tile(launch, u_p, v_p, gx_p, gy_p, it_p, lab_p, sup_x, sup_y,
                      row0, col0, img_h, img_w, fuse, *consts,
                      f_max=GATED_MAX_FUSE):
    """``fuse`` gated sweeps on one halo'd tile as ceil(fuse / f_max) calls
    of ``launch``, which takes :func:`irls_gated_tile_sweeps_plain`'s
    arguments and runs at most ``f_max`` sweeps: each call takes the last
    one's core, its origin moved in by the sweeps run so far (``it_p``
    rides with the fixed fields)."""
    return _build.split_fuse(
        lambda u, v, fixed, off, k: launch(
            u, v, fixed[0], fixed[1], fixed[2], fixed[3], sup_x, sup_y,
            row0 + off, col0 + off, img_h, img_w, k, *consts),
        u_p, v_p, fuse, f_max, (gx_p, gy_p, it_p, lab_p), step=1)


def _gated_tile_launch(u_p, v_p, gx_p, gy_p, it_p, lab_p, sup_x, sup_y, row0,
                       col0, img_h, img_w, fuse, lambda_d, lambda_s, sigma_d,
                       sigma_s):
    """One launch of the tile form of irls_gated_kernel (arguments as
    :func:`irls_gated_tile_sweeps_plain`'s); returns the core."""
    global LAUNCHES_GATED_TILE
    gated_core(fuse)
    lib = _lib_gated()
    hh, hw = gx_p.shape
    batch = u_p.shape[0] if u_p.dim() == 3 else 1
    u_out = u_p.new_empty((*u_p.shape[:-2], hh - 2 * fuse, hw - 2 * fuse))
    v_out = torch.empty_like(u_out)
    with torch.cuda.device(u_p.device):
        rc = lib.irls_gated_tile_launch(
            u_p.data_ptr(), v_p.data_ptr(), gx_p.data_ptr(), gy_p.data_ptr(),
            it_p.data_ptr(), lab_p.data_ptr(), sup_x.data_ptr(),
            sup_y.data_ptr(), u_out.data_ptr(), v_out.data_ptr(), hh, hw,
            int(row0), int(col0), img_h, img_w, batch, fuse, lambda_d,
            lambda_s, sigma_d, sigma_s,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "irls_gated", rc)
    LAUNCHES_GATED_TILE += 1
    return u_out, v_out
