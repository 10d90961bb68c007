"""Mean-shift segmentation (counterpart of :mod:`tpuflow.segmentation`)."""

from tpuflow_torch.segmentation.meanshift import (  # noqa: F401
    SegmentationResult,
    mean_shift_filter,
    mean_shift_filter_sharded,
    segment_meanshift,
    segment_meanshift_async,
)
