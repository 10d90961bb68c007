from tpuflow_torch.pyramid.pyramid import (  # noqa: F401
    add_vector_offset,
    dt_level,
    dt_pyramid,
    grad_level,
    grad_pyramid,
    level_down,
    pyramid_sizes,
    pyramider,
    upsample_nearest,
)
