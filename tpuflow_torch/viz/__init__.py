"""Flow and scene visualization, array out (port of :mod:`tpuflow.viz`)."""

from tpuflow_torch.viz.quiver import plot_quiver  # noqa: F401
from tpuflow_torch.viz.colorwheel import flow_to_color  # noqa: F401
from tpuflow_torch.viz.plot2d import plot_segments, superimpose  # noqa: F401
from tpuflow_torch.viz.plot3d import (  # noqa: F401
    ParticleState,
    galaxy_step,
    gravity_step,
    render_scene,
)
