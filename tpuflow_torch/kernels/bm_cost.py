"""The region matcher's per-region moment sums: the CUDA kernel and its
plain version.

For every region of a label map, every candidate displacement (dy, dx)
and each of one or two reference frames, :func:`region_sums` returns the
float64 sums over the region's pixels of the four fields the MAD + ZNCC
cost needs: the Lab L1 distance (:func:`_l1`), the reference's L, L
squared and the product with the current frame's L, each computed in
float32 (and rounded to bfloat16 where ``bf16``), as the (n_regions,
4 n_ref, n_cand) table ``acc_var``; and the candidate-invariant (n, sum
L, sum L^2) of the current frame, ``acc_fix`` (n_regions, 3).
Out-of-frame reference reads are zeros.

A CPU tensor takes the plain version :func:`_matmul_sums` (per 32-row
strip of the host label map and per chunk of candidates a one-hot
float64 product). A CUDA tensor takes ``csrc/bm_cost.cu`` (the source
says what bounds it on the H100 and how the design answers), or the call
raises: two launches over the caller's :func:`segment_plan` of the labels
on the card give the table, with no host sync, each sum taken in a fixed
order that depends on the labels and the frame alone, so a slice of the
candidates, or one reference of two, gives bitwise the same columns. The
kernel's sums differ from the plain version's only in the order of the
float64 adds.
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
# Rows per one-hot strip of the plain version (tpuflow's ``_STRIP``).
_STRIP = 32


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


def _check(cur_lab, refs, labels, seg_plan, n_regions: int, cand) -> None:
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
    labels = np.asarray(labels)
    if labels.size and (labels.min() < 0 or labels.max() >= n_regions):
        raise ValueError(f"region_sums: labels outside [0, {n_regions})")
    for t in seg_plan:
        if t.device != dev or t.dtype != torch.int64:
            raise ValueError(f"region_sums: the CUDA kernel takes an int64 "
                             f"plan on {dev}, got {t.dtype} on {t.device}")


def region_sums(cur_lab: torch.Tensor, refs, labels: np.ndarray, seg_plan,
                n_regions: int, cand: torch.Tensor, chunk: int, radius: int,
                bf16: bool = False):
    """(acc_var (n_regions, 4 n_ref, n_cand), acc_fix (n_regions, 3)), the
    float64 moment sums of every region of the host label map ``labels``
    (values in [0, n_regions)) for the candidates ``cand`` ((n, (dy, dx))
    on the frames' device, |d| <= ``radius``) against each of ``refs``.
    ``seg_plan``: :func:`segment_plan` of the same labels on the frames'
    device.

    CPU tensors take the plain version (:func:`_matmul_sums` of the host
    labels, chunks of ``chunk`` candidates); a CUDA tensor (contiguous
    float32 (H, W, 3) frames, one or two references, int64 candidates)
    takes the two launches of ``csrc/bm_cost.cu`` (:func:`launch`) over
    ``seg_plan``, or raises."""
    refs = list(refs)
    _check(cur_lab, refs, labels, seg_plan, n_regions, cand)
    if cur_lab.device.type == "cpu":
        return _matmul_sums(cur_lab, refs, labels, n_regions, cand, chunk,
                            radius, bf16)
    return launch(cur_lab, refs, seg_plan, n_regions, cand, bf16)


def launch(cur_lab, refs, seg_plan, n_regions: int, cand, bf16: bool):
    """The two launches of csrc/bm_cost.cu on checked CUDA inputs and a
    :func:`segment_plan`; returns (acc_var, acc_fix) without a host
    sync."""
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


# ---------------------------------------------------------------------------
# The plain version


def _l1(cur: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Mean Lab L1 distance in standard Lab units, channels summed in order."""
    d = (cur - ref).abs()
    return (d[..., 0] + d[..., 1] + d[..., 2]) * (LAB_SCALE / 3.0)


def _shifted(ref_p: torch.Tensor, radius: int, y0: int, rows: int,
             d: torch.Tensor) -> torch.Tensor:
    """(rows * W, CH, C): the reference at (x + dx, y + dy) for the rows
    [y0, y0 + rows) and each of the CH candidates ``d`` ((dy, dx) on the
    device), read from ``ref_p``, the frame zero-padded by ``radius``."""
    w = ref_p.shape[1] - 2 * radius
    dev = ref_p.device
    yy = (torch.arange(y0, y0 + rows, device=dev)[:, None, None]
          + radius + d[None, None, :, 0])                 # (rows, 1, CH)
    xx = (torch.arange(w, device=dev)[None, :, None]
          + radius + d[None, None, :, 1])                 # (1, W, CH)
    return ref_p[yy, xx].reshape(rows * w, d.shape[0], ref_p.shape[2])


def _strip_plan(labels: np.ndarray, device):
    """Per strip of :data:`_STRIP` rows: (y0, rows, the regions present
    (a device index), each pixel's position among them (a device index),
    their count). Computed on the host from the host label map, then
    uploaded strip by strip."""
    h = labels.shape[0]
    host = []
    for y0 in range(0, h, _STRIP):
        rows = min(_STRIP, h - y0)
        present, local = np.unique(labels[y0 : y0 + rows],
                                   return_inverse=True)
        host.append((y0, rows, present.astype(np.int64),
                     local.reshape(-1).astype(np.int64)))
    plan = []
    with record_span("wait.strip_plan", count=2 * len(host)):
        for y0, rows, present, local in host:
            local_t = torch.from_numpy(local).to(device)
            plan.append((y0, rows, torch.from_numpy(present).to(device),
                         local_t, len(present)))
    return plan


def _matmul_sums(cur_lab, refs, labels: np.ndarray, n_regions: int, cand,
                 chunk: int, radius: int, bf16: bool = False):
    """The plain version of :func:`region_sums` (tpuflow's strip one-hot
    evaluator) for one or more reference frames matched against the same
    current frame and host labels: the candidate-invariant current-frame
    moments reduce once per strip, and each candidate chunk builds 4
    channels per reference (L1, b, b^2, a*b) and reduces them in one
    ``L^T @ F`` product over the regions present in the strip. ``bf16``
    rounds those 4 channels to bfloat16 before the sum (tpuflow's
    ``mxu_dtype``; the one-hot L and the current-frame moments stay
    exact). Returns (acc_var (n_regions, 4 n_ref, n_cand), acc_fix
    (n_regions, 3): n, sum a, sum a^2)."""
    dev = cur_lab.device
    h, w, c = cur_lab.shape
    R = radius
    n_ref = len(refs)
    refs_p = [torch.nn.functional.pad(r, (0, 0, R, R, R, R)) for r in refs]
    n_cand = cand.shape[0]
    # Channel-major per region, (n_regions, 4 * n_ref, n_cand): each
    # chunk's fields stack in runs of CH contiguous values.
    acc_var = torch.zeros((n_regions, 4 * n_ref, n_cand), dtype=torch.float64,
                          device=dev)
    acc_fix = torch.zeros((n_regions, 3), dtype=torch.float64, device=dev)
    plan = _strip_plan(labels, dev)
    chunks = 0
    for y0, rows, present, local, n_p in plan:
        L = torch.nn.functional.one_hot(local, n_p).to(torch.float64)
        cur_s = cur_lab[y0 : y0 + rows].reshape(rows * w, 1, c)
        a = cur_s[:, 0, 0]
        # Candidate-invariant current-frame moments: n, sum a, sum a^2.
        fix = torch.stack([torch.ones_like(a), a, a * a], dim=-1)
        acc_fix[present] += L.t() @ fix.to(torch.float64)
        for k0 in range(0, n_cand, chunk):
            d = cand[k0 : k0 + chunk]
            fields = []
            for ref_p in refs_p:
                sub = _shifted(ref_p, R, y0, rows, d)          # (P, CH, C)
                b = sub[..., 0]
                fields += [_l1(cur_s, sub), b, b * b, cur_s[..., 0] * b]
            F = torch.stack(fields, dim=1).reshape(rows * w, -1)
            if bf16:
                F = F.to(torch.bfloat16)
            F = F.to(torch.float64)
            acc_var[present, :, k0 : k0 + d.shape[0]] += (L.t() @ F).view(
                n_p, 4 * n_ref, d.shape[0])
            chunks += 1
    note(strips=len(plan), chunks=chunks)
    return acc_var, acc_fix
