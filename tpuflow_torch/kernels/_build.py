"""Build and load the hand-written CUDA kernels, and check their arguments.

Each ``tpuflow_torch/csrc/<name>.cu`` has a plain C interface. It is
compiled with nvcc for Hopper (``sm_90a``) into
``build/tpuflow_torch/lib<name>_<hash>.so`` at first use and loaded with
ctypes. The hash covers the source, the ``csrc`` headers it includes and
the flags, so an edited source or header is rebuilt. Nothing here runs at
import time; a failed build raises with nvcc's output. nvcc's ``-Xptxas
-v`` report (registers, shared memory, spills) is kept beside the library
as ``<name>.log``.

``-fmad=false`` keeps nvcc from contracting a*b+c into one fused
multiply-add, so a kernel rounds after every operation as PyTorch's
eager elementwise ops do, and its plain version on the card can be held
to it tightly.

:func:`split_fuse` runs a block of sweeps deeper than one launch of a
fused sweep kernel takes as several launches of that kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpuflow_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# Shared memory one block may take on Hopper (227 KB; above 48 KB only
# as dynamic shared memory, opted into by the launcher).
MAX_SMEM_BYTES = 232448


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def source_bytes(src: Path) -> bytes:
    """A source with the ``csrc`` headers it includes (``#include "x.cuh"``,
    recursively), so that an edited header changes the library's hash."""
    out, seen, todo = b"", set(), [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        out += text
        todo += [CSRC / m.decode()
                 for m in re.findall(rb'^#include "([^"]+)"', text, re.M)]
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source_bytes(src)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        tmp.replace(out)
    return ctypes.CDLL(str(out))


def check_fields(name: str, *fields: torch.Tensor) -> None:
    """Every field is 2-D, of one shape, on one device. On CUDA the kernel
    also needs contiguous float32; anything else raises (no fallback)."""
    first = fields[0]
    for f in fields:
        if f.dim() != 2 or f.shape != first.shape:
            raise ValueError(f"{name}: fields must share one (H, W) shape, "
                             f"got {tuple(f.shape)} and {tuple(first.shape)}")
        if f.device != first.device:
            raise ValueError(f"{name}: fields on {f.device} and {first.device}")
    if first.device.type == "cpu":
        return
    if first.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {first.device}")
    for f in fields:
        if f.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, "
                            f"got {f.dtype}")
        if not f.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous fields")


def check_launch(lib: ctypes.CDLL, prefix: str, rc: int) -> None:
    """Raise if the launcher returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"{prefix}_error_string")(rc).decode()
        raise RuntimeError(f"{prefix} launch failed: CUDA error {rc} ({msg})")


def core(name: str, stage: tuple[int, int], halo: int) -> tuple[int, int]:
    """The core one block of a fused sweep kernel writes: its (rows,
    columns) staged tile less ``halo`` cells on each side. Raises if
    nothing is left."""
    out = (stage[0] - 2 * halo, stage[1] - 2 * halo)
    if min(out) < 1:
        raise ValueError(f"{name}: a {halo}-cell halo leaves no core in the "
                         f"{stage[0]}x{stage[1]} staged tile")
    return out


def max_halo(stage: tuple[int, int]) -> int:
    """The widest halo that leaves a core in a staged tile."""
    return (min(stage) - 1) // 2


def fuse_parts(fuse: int, f_max: int) -> list[int]:
    """``fuse`` sweeps as ceil(fuse / f_max) parts of near-equal depth,
    none deeper than ``f_max``, the deeper ones first."""
    if f_max < 1:
        raise ValueError(f"no sweep fits one launch (f_max={f_max})")
    n = -(-fuse // f_max)
    q, extra = divmod(fuse, n)
    return [q + 1] * extra + [q] * (n - extra)


def split_fuse(sweep, u, v, fuse: int, f_max: int, fixed=(), step: int = 0):
    """``fuse`` sequential sweeps as one call of ``sweep(u, v, fixed, off,
    k)`` per part of :func:`fuse_parts`, k sweeps each; returns the last
    call's (u, v).

    Whole-frame sweeps (``step`` 0) hand (u, v) on. A tile sweep returns
    the core of its halo'd input, ``step`` cells in per sweep on each side:
    that core is the next call's input, ``off`` (the cells consumed so far
    on each side) moves its frame origin in, and the fixed fields are cut to
    the same window (a contiguous copy, made only between calls). Sweeps
    are sequential, so the result is bitwise that of one call of all
    ``fuse``."""
    off = 0
    for i, k in enumerate(fuse_parts(fuse, f_max)):
        if i and step:
            d = last * step
            fixed = [f[..., d : f.shape[-2] - d, d : f.shape[-1] - d]
                     .contiguous() for f in fixed]
        u, v = sweep(u, v, fixed, off, k)
        off += k * step
        last = k
    return u, v
