"""HOG features and matching (counterpart of :mod:`tpuflow.features`)."""

from tpuflow_torch.features.hog import (  # noqa: F401
    block_normalize,
    block_normalize_integral,
    compute_hog,
    hog_descriptor,
    hog_matching,
    orientation,
)
