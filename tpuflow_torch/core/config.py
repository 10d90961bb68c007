"""Configuration dataclasses (port of :mod:`tpuflow.core.config`).

Ported so far: the output-mode bitmask the flagship branches on,
``MultipleMotionParam``, and ``PlotParam`` with the plot constants the
viewers use, with the same names and defaults as the JAX package.
:func:`from_tpuflow` carries a tpuflow instance across by field name,
without importing tpuflow.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

# Mode bitmask (Scratch_Struct.h:84-95)
MODE_OUTPUT_FILTERED_IMAGE = 0x0010
MODE_OUTPUT_BINARY_IMAGE = 0x0020
MODE_OUTPUT_MULTIPLE_MOTIONS_AFFINE = 0x0040
MODE_OUTPUT_OPTICALFLOW = 0x0080
MODE_OUTPUT_AFFINE_BLOCKMATCHING = 0x0100
MODE_OUTPUT_OPTICALFLOW_BLOCKMATCHING = 0x0200
MODE_OUTPUT_HOG_RAW = 0x1000
MODE_OUTPUT_HOG = 0x2000
MODE_OUTPUT_HOG_MATCHING_VECTOR = 0x4000

# PlotOptions (Scratch_Struct.h:92-95)
PLOT_NEGATE = 0x01
PLOT_AS_RESAMPLED = 0x02
PLOT_RESAMPLED_IMG_ONLY = 0x04

# Superimpose colors (Scratch_MeaningfulMotion.h:81-86)
NOT_SUPERIMPOSE, RED, GREEN, BLUE = 0, 1, 2, 3

PLOT_INTENSITY_MAX = 255


@dataclass
class MultipleMotionParam:
    """MULTIPLE_MOTION_PARAM defaults (Scratch_MeaningfulMotion.h:140-147)."""

    level: int = 5
    irls_iter_max: int = 300
    error_min_threshold: float = 1.0e-6
    lambda_d: float = 5.0
    lambda_s: float = 1.0
    sigma_d: float = 12.72
    sigma_s: float = 2.121
    block_matching_block_size: int = 8
    # Flagship block-matching constants (search 61x61, subpixel
    # x2, mean-shift kernel (20, 16/255)); carried for parity with the
    # JAX dataclass (optical_flow_block_matching takes them as arguments,
    # as tpuflow's does).
    bm_search_range: int = 61
    bm_subpixel_scale: int = 2
    bm_kernel_spatial: int = 20
    bm_kernel_intensity: float = 16.0 / 255.0
    bm_method: str = "matmul"
    bm_refine_warp: bool = False
    bm_profile: str | None = None


@dataclass
class PlotParam:
    """X11_PARAM equivalent for the array-out 3-D viewer."""

    int_interval: int = 1
    latitude: int = 0
    longitude: int = 0
    center_x: float = 0.0
    center_y: float = 0.0
    center_z: float = 0.0
    scale: float = 1.0
    plot_z_scale: float = 0.1   # DEFAULT_PLOT_Z_SCALE (Plot_X11.h:17)
    rotate_switch: int = 0
    mode_switch: int = 0
    fill_switch: int = 0


_PORTED = {c.__name__: c for c in (MultipleMotionParam, PlotParam)}


def from_tpuflow(obj, cls=None):
    """Copy the fields of a tpuflow dataclass instance into ``cls``.

    ``cls`` defaults to the port's dataclass of the same name as ``obj``'s
    class (or of its nearest base class). Fields are read by name. A field
    that ``obj`` has and ``cls`` lacks raises, so a field added on the JAX
    side is not dropped silently.
    """
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        raise TypeError(f"expected a dataclass instance, got {type(obj)!r}")
    if cls is None:
        cls = next((_PORTED[k.__name__] for k in type(obj).__mro__
                    if k.__name__ in _PORTED), None)
        if cls is None:
            raise TypeError(f"no ported dataclass for {type(obj).__name__}")
    names = {f.name for f in dataclasses.fields(cls)}
    extra = [f.name for f in dataclasses.fields(obj) if f.name not in names]
    if extra:
        raise ValueError(f"{cls.__name__} has no field(s) {extra}")
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(obj)})
