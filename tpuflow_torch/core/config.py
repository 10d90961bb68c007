"""Configuration dataclasses (port of :mod:`tpuflow.core.config`).

Every dataclass of the JAX package, with the same names, fields and
defaults: ``MultipleMotionParam``, ``FilterParam`` (with
``change_filter``), ``HogParam``, ``PlotParam`` and ``Options``, and the
constants of the output modes, plots, filters, scratch detection and the
a-contrario search. :func:`from_tpuflow` carries a tpuflow instance
across by field name, nested dataclasses included, without importing
tpuflow.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

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

# Filter ids (Scratch_Struct.h:8-11)
FILTER_ID_UNDEFINED, FILTER_ID_EPSILON, FILTER_ID_GAUSSIAN = 0, 1, 2

# Scratch-detection geometry (Scratch_MeaningfulMotion.h:113-120)
SCRATCH_WIDTH = 3
AVE_MAX_FAR = 5
AVE_FAR = SCRATCH_WIDTH // 2 + AVE_MAX_FAR
MEAN_WIDTH = SCRATCH_WIDTH
SCRATCH_MED_THRESHOLD = 3
SCRATCH_AVG_THRESHOLD = 20

# A-contrario constants (Scratch_MeaningfulMotion.h:123-132)
DIR_PROBABILITY = 1.0 / 16.0
DIV_ANGLE = 40
DIV_ANGLE_VERTICAL = 18.0
EPSILON_DEFAULT = 1.0
EXCLUSIVE_PRINCIPLE_MAX_RADIUS = 1.5
ANGLE_MAX = 2.0
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
class FilterParam:
    """FILTER_PARAM (type 0=none, 1=epsilon, 2=gaussian)."""

    type: int = FILTER_ID_UNDEFINED
    size: tuple[int, int] = (21, 21)  # (width, height)
    std_deviation: float = 0.0
    epsilon: float = 0.0

    def change_filter(self, name: str) -> "FilterParam":
        """FILTER_PARAM::ChangeFilter: select by name prefix with defaults
        (epsilon: 21x21/ep=20; gaussian: 21x21/sigma=5)."""
        n = name.lower()
        if n.startswith("e"):
            return dataclasses.replace(
                self, type=FILTER_ID_EPSILON, size=(21, 21), epsilon=20.0)
        if n.startswith("g"):
            return dataclasses.replace(
                self, type=FILTER_ID_GAUSSIAN, size=(21, 21), std_deviation=5.0)
        return dataclasses.replace(self, type=FILTER_ID_UNDEFINED)


@dataclass
class HogParam:
    """HOG_PARAM (HOG/HOG_struct.h, Bins=16 default)."""

    bins: int = 16
    dense: bool = True          # --HOG_densely is the default (main.cpp:55)
    signed_orientation: bool = True  # --HOG_signed is the default (main.cpp:57)


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


@dataclass
class Options:
    """OPTIONS (Scratch_Struct.cpp:194-209 defaults)."""

    resample_size: tuple[int, int] = (0, 0)  # (width, height); 0 = off
    resample_method: int = 0  # 0 = zero-order hold, 1 = bicubic
    mode: int = 0
    max_length: int = 0
    max_output_length: int = 0
    exclusive_principle: bool = False
    superimpose: int = NOT_SUPERIMPOSE
    plot_options: int = 0
    s_med: int = SCRATCH_MED_THRESHOLD
    s_avg: int = SCRATCH_AVG_THRESHOLD
    p: float = DIR_PROBABILITY
    ep: float = EPSILON_DEFAULT
    exclusive_max_radius: float = EXCLUSIVE_PRINCIPLE_MAX_RADIUS
    multiple_motion_param: MultipleMotionParam = field(
        default_factory=MultipleMotionParam)
    hog_param: HogParam = field(default_factory=HogParam)
    filter_param: FilterParam = field(default_factory=FilterParam)
    plot_param: PlotParam = field(default_factory=PlotParam)
    x11_plot: bool = False
    # Run the flagship on a mesh of this many ranks (0 = one device):
    # run_pipeline spawns them once (tpuflow_torch.dist.run_on_mesh).
    devices: int = 0
    # The reference's compiled-in debug dumps (Pyramid_%04d.pgm,
    # filtered.pgm, IndexMap.pgm), written next to the output file.
    debug_dumps: bool = False


_PORTED = {c.__name__: c for c in (MultipleMotionParam, FilterParam,
                                   HogParam, PlotParam, Options)}


def from_tpuflow(obj, cls=None):
    """Copy the fields of a tpuflow dataclass instance into ``cls``.

    ``cls`` defaults to the port's dataclass of the same name as ``obj``'s
    class (or of its nearest base class). Fields are read by name, and a
    field that holds a dataclass instance is converted the same way, so a
    tpuflow ``Options`` carries the port's own nested params. A field
    that ``obj`` has and ``cls`` lacks raises, so a field added on the
    JAX side is not dropped silently.
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
    def value(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return from_tpuflow(v)
        return v

    return cls(**{f.name: value(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)})
