"""The region matcher's per-region moment sums: the CUDA kernel and its
plain version.

For every region of a label map, every candidate displacement (dy, dx)
and each of one or two reference frames, :func:`region_sums` returns the
float64 sums over the region's pixels of the four fields the MAD + ZNCC
cost needs (:func:`tpuflow_torch.blockmatching.matcher._matmul_sums`):
the Lab L1 distance, the reference's L, L squared and the product with
the current frame's L, each computed in float32 (and rounded to bfloat16
where ``bf16``), as the (n_regions, 4 n_ref, n_cand) table ``acc_var``;
and the candidate-invariant (n, sum L, sum L^2) of the current frame,
``acc_fix`` (n_regions, 3). Out-of-frame reference reads are zeros.

A CPU tensor takes the plain version, the matcher's own strip loop
(``matcher._matmul_sums``: per 32-row strip and per chunk of candidates a
one-hot float64 product). A CUDA tensor takes ``csrc/bm_cost.cu`` (the
source says what bounds it on the H100 and how the design answers), or
the call raises: the labels go to the card once (one host sync), are
sorted there (:func:`segment_plan`), and two launches give the table,
each sum taken in a fixed order that depends on the labels and the frame
alone, so a slice of the candidates, or one reference of two, gives
bitwise the same columns. The kernel's sums differ from the plain
version's only in the order of the float64 adds.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpuflow_torch.core.color import LAB_SCALE
from tpuflow_torch.kernels import _build
from tpuflow_torch.utils.telemetry import note, record_span

# Launches of the CUDA kernels in this process (never the plain version):
# two a call, the sums and the combine of the larger regions' segments.
LAUNCHES = 0
# Pixels one block of the sums kernel takes of one region; a larger region
# is split into segments of SEGMENT pixels, added in order by the combine.
SEGMENT = 1024
# Most block rows of a launch (CUDA's grid y limit): n_regions plus the
# frame's pixels over SEGMENT.
MAX_SLOTS = 65535


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from csrc/bm_cost.cu."""
    lib.bm_cost_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float]
        + [ctypes.c_void_p])
    lib.bm_cost_launch.restype = ctypes.c_int
    lib.bm_cost_blocks_per_sm.argtypes = [ctypes.c_int] * 2
    lib.bm_cost_blocks_per_sm.restype = ctypes.c_int
    lib.bm_cost_error_string.argtypes = [ctypes.c_int]
    lib.bm_cost_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    return _bind(_build.load("bm_cost"))


def blocks_per_sm(n_ref: int, bf16: bool) -> int:
    """Blocks of the sums kernel one SM of the current card holds at once
    (CUDA's occupancy calculator)."""
    lib = _lib()
    n = lib.bm_cost_blocks_per_sm(int(n_ref), int(bf16))
    _build.check_launch(lib, "bm_cost", -n if n < 0 else 0)
    return n


def slots(n_regions: int, n_pixels: int) -> int:
    """Block rows of a launch: every region's segments fit in n_regions +
    n_pixels // SEGMENT (an empty region takes one, to write its zeros)."""
    return int(n_regions) + int(n_pixels) // SEGMENT


def segment_plan(labels: torch.Tensor, n_regions: int):
    """The kernel's plan from an (H, W) integer label map on its device,
    with no host sync: the stable label sort ``perm`` (raster order within
    a region), the region bounds in it (n_regions + 1,) and ``seg_end``,
    the running count of segments (max(1, ceil(pixels / SEGMENT)) a
    region), all int64."""
    flat = labels.reshape(-1)
    values, perm = torch.sort(flat, stable=True)
    bounds = torch.searchsorted(
        values, torch.arange(n_regions + 1, dtype=flat.dtype,
                             device=flat.device))
    counts = bounds[1:] - bounds[:-1]
    seg_end = torch.cumsum(torch.clamp_min(
        torch.div(counts + (SEGMENT - 1), SEGMENT, rounding_mode="floor"),
        1), 0)
    return perm, bounds, seg_end


def _check(cur_lab, refs, labels, n_regions: int, cand) -> None:
    """Shapes and devices for both versions; dtype and layout for the
    kernel. Raises on anything the version the device picks does not
    take."""
    if cur_lab.dim() != 3 or cur_lab.shape[-1] != 3:
        raise ValueError(f"region_sums: need (H, W, 3) Lab, got "
                         f"{tuple(cur_lab.shape)}")
    if not refs:
        raise ValueError("region_sums: no reference frame")
    for r in refs:
        if r.shape != cur_lab.shape or r.device != cur_lab.device:
            raise ValueError(f"region_sums: reference {tuple(r.shape)} on "
                             f"{r.device}, current {tuple(cur_lab.shape)} on "
                             f"{cur_lab.device}")
    if tuple(np.shape(labels)) != tuple(cur_lab.shape[:2]):
        raise ValueError(f"region_sums: labels {np.shape(labels)} for a "
                         f"{tuple(cur_lab.shape[:2])} frame")
    if cand.dim() != 2 or cand.shape[-1] != 2 or cand.shape[0] < 1:
        raise ValueError(f"region_sums: need (n, 2) candidates, got "
                         f"{tuple(cand.shape)}")
    if cand.device != cur_lab.device:
        raise ValueError(f"region_sums: candidates on {cand.device}, frames "
                         f"on {cur_lab.device}")
    dev = cur_lab.device
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"region_sums: no kernel for device {dev}")
    for f in (cur_lab, *refs):
        if f.dtype != torch.float32 or not f.is_contiguous():
            raise TypeError(f"region_sums: the CUDA kernel takes contiguous "
                            f"float32 frames, got {f.dtype}")
    if cand.dtype != torch.int64:
        raise TypeError(f"region_sums: the CUDA kernel takes int64 "
                        f"candidates, got {cand.dtype}")
    if len(refs) > 2:
        raise ValueError(f"region_sums: the CUDA kernel takes one or two "
                         f"references, got {len(refs)}")
    h, w = cur_lab.shape[:2]
    if slots(n_regions, h * w) > MAX_SLOTS:
        raise ValueError(f"region_sums: {n_regions} regions on {h}x{w} "
                         f"need more than {MAX_SLOTS} block rows")


def region_sums(cur_lab: torch.Tensor, refs, labels: np.ndarray,
                n_regions: int, cand: torch.Tensor, chunk: int, radius: int,
                bf16: bool = False):
    """(acc_var (n_regions, 4 n_ref, n_cand), acc_fix (n_regions, 3)), the
    float64 moment sums of every region of the host label map ``labels``
    (values in [0, n_regions)) for the candidates ``cand`` ((n, (dy, dx))
    on the frames' device, |d| <= ``radius``) against each of ``refs``.

    CPU tensors take the plain version (``matcher._matmul_sums``, chunks of
    ``chunk`` candidates); a CUDA tensor (contiguous float32 (H, W, 3)
    frames, one or two references, int64 candidates) takes the two
    launches of ``csrc/bm_cost.cu`` (:func:`launch`), or raises."""
    refs = list(refs)
    _check(cur_lab, refs, labels, n_regions, cand)
    if cur_lab.device.type == "cpu":
        from tpuflow_torch.blockmatching import matcher

        return matcher._matmul_sums(cur_lab, refs, labels, n_regions, cand,
                                    chunk, radius, bf16)
    labels = np.asarray(labels)
    if labels.size and (labels.min() < 0 or labels.max() >= n_regions):
        raise ValueError(f"region_sums: labels outside [0, {n_regions})")
    return launch(cur_lab, refs, plan(labels, n_regions, cur_lab.device),
                  n_regions, cand, bf16)


def plan(labels: np.ndarray, n_regions: int, device):
    """:func:`segment_plan` of the host label map, which goes to ``device``
    once (one host sync)."""
    with record_span("wait.sums_labels"):
        labels_t = torch.from_numpy(
            np.ascontiguousarray(labels, dtype=np.int32)).to(device)
    return segment_plan(labels_t, n_regions)


def launch(cur_lab, refs, seg_plan, n_regions: int, cand, bf16: bool):
    """The two launches of csrc/bm_cost.cu on checked CUDA inputs and a
    :func:`plan`; returns (acc_var, acc_fix) without a host sync."""
    global LAUNCHES
    perm, bounds, seg_end = seg_plan
    dev = cur_lab.device
    h, w = cur_lab.shape[:2]
    n_ref, n_cand = len(refs), cand.shape[0]
    cur = cur_lab.permute(2, 0, 1).contiguous()
    ref = torch.stack([r.permute(2, 0, 1) for r in refs])
    n_slots = slots(n_regions, h * w)
    rows = max(n_slots - n_regions, 1)
    acc_var = torch.empty((n_regions, 4 * n_ref, n_cand), dtype=torch.float64,
                          device=dev)
    acc_fix = torch.empty((n_regions, 3), dtype=torch.float64, device=dev)
    scratch = torch.empty((rows, 4 * n_ref, n_cand), dtype=torch.float64,
                          device=dev)
    fix_scratch = torch.empty((rows, 3), dtype=torch.float64, device=dev)
    cand = cand.contiguous()
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.bm_cost_launch(
            cur.data_ptr(), ref.data_ptr(), perm.data_ptr(),
            bounds.data_ptr(), seg_end.data_ptr(), cand.data_ptr(),
            acc_var.data_ptr(), acc_fix.data_ptr(), scratch.data_ptr(),
            fix_scratch.data_ptr(), int(n_regions), n_slots, h, w, n_cand,
            n_ref, int(bool(bf16)), SEGMENT, float(LAB_SCALE / 3.0),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(lib, "bm_cost", rc)
    LAUNCHES += 2
    note(launches=2)
    return acc_var, acc_fix
