"""VALID separable correlation: the CUDA kernel and its plain version.

Counterpart of ``tpuflow/kernels/sepconv.py::sep_conv2d_valid_pallas``.
On a pre-padded (Hp, Wp) image it correlates the rows with ``ky``, then
the columns with ``kx``, and returns the (Hp - len(ky) + 1,
Wp - len(kx) + 1) VALID result; the caller pads for its border policy
(:func:`tpuflow_torch.ops.filters.sep_conv2d`).

:func:`sep_conv2d_valid` takes the taps on the host. They are rounded
once to the image's dtype (float32 for the kernel), and both versions
multiply by the rounded values and add the terms in tap order, so on the
card the kernel (``csrc/sepconv.cu``, one launch for both passes, each
streaming the taps past register accumulators in tap order) matches
:func:`sep_conv2d_valid_plain` bitwise. A CPU tensor takes the plain
version; a CUDA tensor takes the kernel or raises. The TPU kernel's
log2-doubling sum for uniform taps is not ported: every tap list runs the
same direct loop.

The form is picked by the tap counts alone (:func:`form_for`): up to
MAX_TAPS a axis the taps ride in the launch's parameters, above it they
are copied to the card first; where the first pass's rows do not fit one
block (``smem_bytes`` past ``_build.MAX_SMEM_BYTES``, more than ~650
``kx`` taps), the wide form runs both passes as two launches, one thread
an output, with the rows in device scratch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpuflow_torch.kernels import _build

# Launches of the CUDA kernel in this process (never the plain version).
LAUNCHES = 0
# Output tile of one block and its thread count (csrc/sepconv.cu's TH, TW
# and THREADS). The first pass reads the input from device memory into
# registers; shared memory holds its TILE_H x (TILE_W + nkx - 1) result (an
# odd pitch) and the TILE_H x (TILE_W + 1) output tile. ACC outputs per
# thread and pass.
TILE_H = 64
TILE_W = 128
THREADS = 256
ACC = 16
# Taps per axis the kernel's parameter struct holds (csrc/sepconv.cu);
# smem_bytes(MAX_TAPS, MAX_TAPS) fits one block. A larger count takes its
# taps from device memory (the DEVICE_TAPS instantiation).
MAX_TAPS = 128
DEVICE_TAPS = -1
# Tap counts (the same on both axes) compiled into an instantiation of
# their own (csrc/sepconv.cu's kernel_for): Farneback's box at 15, 48 and
# 64 taps. Every other pair takes the instantiation with the count at run
# time; both sum in the same order.
COMPILED_TAPS = (15, 48, 64)


def instantiation(nky: int, nkx: int) -> tuple[int, int]:
    """The template arguments of the kernel that runs ``nky``, ``nkx``
    taps: the counts where they are compiled in, (DEVICE_TAPS,
    DEVICE_TAPS) where the parameter struct cannot hold them, else
    (0, 0)."""
    if max(nky, nkx) > MAX_TAPS:
        return DEVICE_TAPS, DEVICE_TAPS
    return (nky, nkx) if nky == nkx and nky in COMPILED_TAPS else (0, 0)


def form_for(nky: int, nkx: int) -> str:
    """"staged" (one launch, the rows in shared memory) where one block's
    tile fits, else "wide" (two launches, the rows in device scratch)."""
    return ("staged" if smem_bytes(nky, nkx) <= _build.MAX_SMEM_BYTES
            else "wide")


def _lib() -> ctypes.CDLL:
    lib = _build.load("sepconv")
    lib.sep_conv2d_valid_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
        + [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.sep_conv2d_valid_launch.restype = ctypes.c_int
    lib.sep_conv2d_valid_wide_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.sep_conv2d_valid_wide_launch.restype = ctypes.c_int
    lib.sep_conv2d_valid_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.sep_conv2d_valid_blocks_per_sm.restype = ctypes.c_int
    lib.sep_conv2d_valid_error_string.argtypes = [ctypes.c_int]
    lib.sep_conv2d_valid_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(nky: int, nkx: int) -> int:
    """Shared memory of one block (the same for every ``nky``)."""
    return 4 * TILE_H * (((TILE_W + nkx - 1) | 1) + TILE_W + 1)


def blocks_per_sm(nky: int, nkx: int) -> int:
    """Blocks of the kernel one SM of the current card holds at once for
    ``nky``, ``nkx`` taps (CUDA's occupancy calculator)."""
    lib = _lib()
    n = lib.sep_conv2d_valid_blocks_per_sm(nky, nkx)
    _build.check_launch(lib, "sep_conv2d_valid", -n if n < 0 else 0)
    return n


def host_taps(taps, dtype: torch.dtype) -> np.ndarray:
    """1-D host taps rounded once to ``dtype`` (float32 or float64)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return np.asarray(taps, dtype=np.float64).reshape(-1).astype(np_dtype)


def device_taps(device: torch.device, *taps: np.ndarray) -> torch.Tensor:
    """The host taps, concatenated, on ``device``: copied from pinned memory
    without waiting for the stream (the copy is queued on it)."""
    return torch.from_numpy(np.concatenate(taps)).pin_memory().to(
        device, non_blocking=True)


def _pass(a: torch.Tensor, taps: np.ndarray, axis: int,
          n_out: int) -> torch.Tensor:
    """One VALID correlation pass along ``axis``, terms added in tap order."""
    out = None
    for d, t in enumerate(taps):
        term = a.narrow(axis, d, n_out) * float(t)
        out = term if out is None else out + term
    return out


def sep_conv2d_valid_plain(padded: torch.Tensor, ky: np.ndarray,
                           kx: np.ndarray) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (``ky``/``kx`` as given by
    :func:`host_taps`)."""
    hp, wp = padded.shape
    rows = _pass(padded, ky, 0, hp - len(ky) + 1)
    return _pass(rows, kx, 1, wp - len(kx) + 1)


def sep_conv2d_valid(padded: torch.Tensor, ky, kx) -> torch.Tensor:
    """VALID separable correlation of a pre-padded (Hp, Wp) image.

    CPU tensors take :func:`sep_conv2d_valid_plain`; a CUDA tensor
    (contiguous float32) takes one launch of the CUDA kernel, or two of
    its wide form (:func:`form_for`), or raises.
    """
    _build.check_fields("sep_conv2d_valid", padded)
    ky = host_taps(ky, padded.dtype)
    kx = host_taps(kx, padded.dtype)
    hp, wp = padded.shape
    if len(ky) < 1 or len(kx) < 1 or hp < len(ky) or wp < len(kx):
        raise ValueError(f"sep_conv2d_valid: taps ({len(ky)}, {len(kx)}) do "
                         f"not fit the padded image ({hp}, {wp})")
    if padded.device.type == "cpu":
        return sep_conv2d_valid_plain(padded, ky, kx)
    if form_for(len(ky), len(kx)) == "wide":
        return _wide_launch(padded, ky, kx)
    return _launch(padded, ky, kx)


def _launch(padded, ky, kx):
    """One launch of sep_conv2d_valid_kernel (arguments as
    :func:`sep_conv2d_valid_plain`'s)."""
    global LAUNCHES
    lib = _lib()
    hp, wp = padded.shape
    out = padded.new_empty((hp - len(ky) + 1, wp - len(kx) + 1))
    with torch.cuda.device(padded.device):
        dev = (None if instantiation(len(ky), len(kx))[0] != DEVICE_TAPS
               else device_taps(padded.device, ky, kx))
        rc = lib.sep_conv2d_valid_launch(
            padded.data_ptr(), out.data_ptr(), hp, wp,
            ky.ctypes.data, len(ky), kx.ctypes.data, len(kx),
            None if dev is None else dev.data_ptr(), TILE_H, TILE_W, THREADS,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "sep_conv2d_valid", rc)
    LAUNCHES += 1
    return out


def _wide_launch(padded, ky, kx):
    """The wide form: the rows pass into device scratch, then the columns
    pass, two launches (arguments as :func:`sep_conv2d_valid_plain`'s)."""
    global LAUNCHES
    lib = _lib()
    hp, wp = padded.shape
    rows = padded.new_empty((hp - len(ky) + 1, wp))
    out = padded.new_empty((hp - len(ky) + 1, wp - len(kx) + 1))
    with torch.cuda.device(padded.device):
        dev = device_taps(padded.device, ky, kx)
        rc = lib.sep_conv2d_valid_wide_launch(
            padded.data_ptr(), rows.data_ptr(), out.data_ptr(), hp, wp,
            dev.data_ptr(), len(ky), len(kx),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "sep_conv2d_valid", rc)
    LAUNCHES += 2
    return out
