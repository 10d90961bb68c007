"""Native (C++) host runtime: PNM and flow codecs, quiver rasterization, a
threaded frame prefetcher and the mean-shift region labeler (port of
:mod:`tpuflow.native`).

``tpuflow_torch/csrc/io_native.cpp`` (standard C++ library only) is
compiled with g++ at first use into
``build/tpuflow_torch/libio_native_<hash>.so`` (the hash covers the source
and the flags, so an edited source is rebuilt) and bound with ctypes.
Nothing is built at import. A failed build raises with g++'s output, and
nothing here falls back to Python: the Python bodies in
:mod:`tpuflow_torch.core.io`, :mod:`tpuflow_torch.viz.quiver` and
:mod:`tpuflow_torch.segmentation.meanshift` are the plain versions the
tests hold this library against.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from tpuflow_torch.kernels._build import BUILD_DIR, CSRC

SRC = CSRC / "io_native.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


class TfImage(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("maxval", ctypes.c_int32),
        ("data", ctypes.POINTER(ctypes.c_double)),
    ]


def build_library() -> Path:
    """Compile io_native.cpp with g++ unless its library exists; returns
    the library's path. Raises with g++'s output if the build fails."""
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libio_native_{digest[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native library needs a C++ "
                           "compiler on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    tmp.replace(out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with its C interface
    declared."""
    lib = ctypes.CDLL(str(build_library()))
    dbl = ctypes.POINTER(ctypes.c_double)
    lib.tf_read_pnm.restype = ctypes.POINTER(TfImage)
    lib.tf_read_pnm.argtypes = [ctypes.c_char_p]
    lib.tf_write_pnm.restype = ctypes.c_int
    lib.tf_write_pnm.argtypes = [ctypes.c_char_p, dbl] + [ctypes.c_int32] * 4
    lib.tf_free_image.argtypes = [ctypes.POINTER(TfImage)]
    lib.tf_write_flow.restype = ctypes.c_int
    lib.tf_write_flow.argtypes = ([ctypes.c_char_p] + [dbl] * 3
                                  + [ctypes.c_int32] * 2)
    lib.tf_flow_size.restype = ctypes.c_int
    lib.tf_flow_size.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int32),
                                 ctypes.POINTER(ctypes.c_int32)]
    lib.tf_read_flow.restype = ctypes.c_int
    lib.tf_read_flow.argtypes = ([ctypes.c_char_p] + [dbl] * 3
                                 + [ctypes.c_int32] * 2)
    lib.tf_draw_quiver.restype = None
    lib.tf_draw_quiver.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
        dbl, dbl, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
    lib.tf_prefetcher_create.restype = ctypes.c_void_p
    lib.tf_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32]
    lib.tf_prefetcher_next.restype = ctypes.POINTER(TfImage)
    lib.tf_prefetcher_next.argtypes = [ctypes.c_void_p]
    lib.tf_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.tf_label_regions.restype = ctypes.c_int32
    lib.tf_label_regions.argtypes = [
        dbl, dbl, ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
        ctypes.c_double, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)]
    return lib


def _ptr(a: np.ndarray, ctype=ctypes.c_double):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def label_regions(pos: np.ndarray, col: np.ndarray, kernel_spatial: float,
                  kernel_intensity: float, min_size: int):
    """Native mean-shift region formation (tf_label_regions): 4-adjacent
    mode merge + tiny-region absorption, bit-identical to
    :func:`tpuflow_torch.segmentation.meanshift._merge_labels_plain`.
    Returns (labels (H, W) int32, n)."""
    lib = load_library()
    h, w = pos.shape[:2]
    pos = np.ascontiguousarray(pos, np.float64)
    col = np.ascontiguousarray(col, np.float64)
    out = np.empty((h, w), np.int32)
    n = lib.tf_label_regions(
        _ptr(pos), _ptr(col), h, w, (0.5 * float(kernel_spatial)) ** 2,
        float(kernel_intensity) ** 2, int(min_size),
        _ptr(out, ctypes.c_int32))
    return out, int(n)


def _image_to_numpy(lib, img_ptr) -> tuple[np.ndarray, int]:
    img = img_ptr.contents
    count = img.width * img.height * img.channels
    arr = np.ctypeslib.as_array(img.data, shape=(count,)).copy()
    if img.channels == 3:
        arr = arr.reshape(img.height, img.width, 3)
    else:
        arr = arr.reshape(img.height, img.width)
    maxval = img.maxval
    lib.tf_free_image(img_ptr)
    return arr, maxval


def read_pnm(path) -> tuple[np.ndarray, int]:
    """Native P5/P6 decode -> (float64 array, maxval)."""
    lib = load_library()
    ptr = lib.tf_read_pnm(str(path).encode())
    if not ptr:
        raise IOError(f"tf_read_pnm failed for {path}")
    return _image_to_numpy(lib, ptr)


def write_pnm(path, img: np.ndarray, maxval: int = 255) -> None:
    """Native P5/P6 encode: values clipped to [0, maxval], rounded."""
    lib = load_library()
    img = np.ascontiguousarray(img, dtype=np.float64)
    channels = 3 if img.ndim == 3 else 1
    h, w = img.shape[:2]
    if lib.tf_write_pnm(str(path).encode(), _ptr(img), w, h, channels,
                        maxval) != 0:
        raise IOError(f"tf_write_pnm failed for {path}")


def write_flow(path, u: np.ndarray, v: np.ndarray,
               score: np.ndarray | None = None) -> None:
    lib = load_library()
    u = np.ascontiguousarray(u, dtype=np.float64)
    v = np.ascontiguousarray(v, dtype=np.float64)
    h, w = u.shape
    sp = None
    if score is not None:
        score = np.ascontiguousarray(score, dtype=np.float64)
        sp = _ptr(score)
    if lib.tf_write_flow(str(path).encode(), _ptr(u), _ptr(v), sp, w,
                         h) != 0:
        raise IOError(f"tf_write_flow failed for {path}")


def read_flow(path, components: int = 2):
    lib = load_library()
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    if lib.tf_flow_size(str(path).encode(), ctypes.byref(w),
                        ctypes.byref(h)) != 0:
        raise IOError(f"tf_flow_size failed for {path}")
    u = np.empty((h.value, w.value), np.float64)
    v = np.empty((h.value, w.value), np.float64)
    s = np.empty((h.value, w.value), np.float64) if components == 3 else None
    if lib.tf_read_flow(str(path).encode(), _ptr(u), _ptr(v),
                        None if s is None else _ptr(s), w.value,
                        h.value) != 0:
        raise IOError(f"tf_read_flow failed for {path}")
    return (u, v, s) if s is not None else (u, v)


class FramePrefetcher:
    """Threaded ahead-of-device PNM loader with ordered delivery.

    Usage::

        with FramePrefetcher(paths, threads=4) as pf:
            for frame, maxval in pf:
                ...
    """

    def __init__(self, paths, threads: int = 2, capacity: int = 4):
        self.lib = load_library()
        self.paths = [str(p) for p in paths]
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._handle = self.lib.tf_prefetcher_create(
            arr, len(self.paths), threads, capacity)
        self._emitted = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._handle:
            self.lib.tf_prefetcher_destroy(self._handle)
            self._handle = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._emitted >= len(self.paths):
            raise StopIteration
        ptr = self.lib.tf_prefetcher_next(self._handle)
        self._emitted += 1
        if not ptr:
            raise IOError(
                f"prefetcher failed to decode {self.paths[self._emitted - 1]}")
        return _image_to_numpy(self.lib, ptr)


def draw_quiver(img_rgb: np.ndarray, u: np.ndarray, v: np.ndarray,
                delta: int = 10, scale: float = 1.0,
                outlier: float = 0.0,
                line_color=(0, 255, 0), tip_color=(255, 0, 0)) -> np.ndarray:
    """Native Bresenham quiver rasterization (plotFlow.cpp semantics);
    returns a new (H, W, 3) uint8 array."""
    lib = load_library()
    out = np.ascontiguousarray(img_rgb, dtype=np.uint8).copy()
    u = np.ascontiguousarray(u, dtype=np.float64)
    v = np.ascontiguousarray(v, dtype=np.float64)
    h, w = u.shape
    lc = (ctypes.c_uint8 * 3)(*line_color)
    tc = (ctypes.c_uint8 * 3)(*tip_color)
    lib.tf_draw_quiver(_ptr(out, ctypes.c_uint8), h, w, _ptr(u), _ptr(v),
                       delta, scale, outlier, lc, tc)
    return out
