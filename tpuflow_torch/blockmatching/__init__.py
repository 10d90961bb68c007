"""Region block matching (counterpart of :mod:`tpuflow.blockmatching`)."""

from tpuflow_torch.blockmatching.matcher import (  # noqa: F401
    BlockMatchResult,
    block_matching_bidirectional,
    block_matching_labels,
    grid_labels,
)
