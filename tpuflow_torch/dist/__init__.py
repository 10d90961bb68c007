"""Multi-device flow: 2-D image tiling over a mesh of ``torch.distributed``
ranks (counterpart of :mod:`tpuflow.dist`).

NCCL between cards, gloo on the CPU (and, staged through the host, between
ranks that share one card). :func:`run_on_mesh` spawns the ranks and runs a
function on each. The flagship's sharded stages are here too: the
candidate-parallel search (``dist/bm.py``), the tiled gated refine and
affine fit (``dist/bm_refine.py``); its tiled mean-shift filter is
``tpuflow_torch.segmentation.meanshift.mean_shift_filter_sharded``.
``farneback_sharded`` (``dist/farneback.py``) tiles Farneback's finest
level on the poly-expansion and blur-solve kernels. ``dist/ops.py``
tiles the L1 image ops, HOG matching and scratch detection.
"""

from tpuflow_torch.dist.mesh import Mesh, make_mesh, mesh_factor, run_on_mesh  # noqa: F401
from tpuflow_torch.dist.halo import (  # noqa: F401
    gather_tiles,
    halo_pad_2d,
    shift_along,
    tile_of,
)
from tpuflow_torch.dist.solvers import (  # noqa: F401
    horn_schunck_sharded,
    horn_schunck_sharded_fused,
    horn_schunck_sharded_fused_dynamic,
    irls_level_sharded,
    irls_level_sharded_fused,
)
from tpuflow_torch.dist.pyramid import optical_flow_pyramid_sharded  # noqa: F401
from tpuflow_torch.dist.scaling import weak_scaling_report  # noqa: F401
from tpuflow_torch.dist.bm import block_matching_labels_sharded  # noqa: F401
from tpuflow_torch.dist.bm_refine import (  # noqa: F401
    affine_parametric_flow_sharded,
    gradient_method_flow_sharded,
    gradient_method_flow_sharded_bidirectional,
)
from tpuflow_torch.dist.farneback import (  # noqa: F401
    farneback_sharded,
    halo_pad_2d_clamp,
)
from tpuflow_torch.dist.ops import (  # noqa: F401
    conv2d_sharded,
    detect_scratch_sharded,
    epsilon_filter_sharded,
    filterer_sharded,
    gaussian_filter_sharded,
    hog_matching_sharded,
    horizontal_median_sharded,
)
