"""Scratch detection and meaningful alignments (counterpart of
:mod:`tpuflow.detection`)."""

from tpuflow_torch.detection.scratch import detect_scratch  # noqa: F401
from tpuflow_torch.detection.alignments import (  # noqa: F401
    Segment,
    aligned_segments_vertical,
    calc_k_l,
    l_min_for,
    pr_table,
)
from tpuflow_torch.detection.exclusive import (  # noqa: F401
    exclusive_index_map,
    exclusive_principle,
    exclusive_segments,
)
