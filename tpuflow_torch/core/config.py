"""Configuration dataclasses (port of :mod:`tpuflow.core.config`).

Only the parameter surface the dense variational solvers read is ported
so far: ``MultipleMotionParam``, with the same field names and defaults
as the JAX package. :func:`from_tpuflow` carries a tpuflow instance
across by field name, without importing tpuflow.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


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
    # JAX dataclass, read by the block-matching slice once it is ported.
    bm_search_range: int = 61
    bm_subpixel_scale: int = 2
    bm_kernel_spatial: int = 20
    bm_kernel_intensity: float = 16.0 / 255.0
    bm_method: str = "matmul"
    bm_refine_warp: bool = False
    bm_profile: str | None = None


def from_tpuflow(obj, cls=MultipleMotionParam):
    """Copy the fields of a tpuflow dataclass instance into ``cls``.

    Fields are read by name. A field that ``obj`` has and ``cls`` lacks
    raises, so a field added on the JAX side is not dropped silently.
    """
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        raise TypeError(f"expected a dataclass instance, got {type(obj)!r}")
    names = {f.name for f in dataclasses.fields(cls)}
    extra = [f.name for f in dataclasses.fields(obj) if f.name not in names]
    if extra:
        raise ValueError(f"{cls.__name__} has no field(s) {extra}")
    return cls(**{f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(obj)})
