"""L1 image ops (counterpart of :mod:`tpuflow.ops`)."""

from tpuflow_torch.ops.filters import (  # noqa: F401
    box_filter,
    conv2d,
    epsilon_filter,
    filterer,
    gaussian_filter,
    gaussian_kernel,
    horizontal_median,
    sep_conv2d,
)
from tpuflow_torch.ops.derivatives import (  # noqa: F401
    derivation_abs,
    derivative_angler,
    derivator,
    sobel_opencv,
)
