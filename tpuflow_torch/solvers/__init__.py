"""Dense flow solvers (counterpart of :mod:`tpuflow.solvers`).

As in tpuflow, the package exports the solver functions by name, so
``tpuflow_torch.solvers.horn_schunck`` is the function.
"""

from tpuflow_torch.solvers.horn_schunck import (  # noqa: F401
    horn_schunck,
    horn_schunck_classic,
    hs_gradients,
)
from tpuflow_torch.solvers.black_anandan import (  # noqa: F401
    irls_energy,
    irls_grad,
    irls_optical_flow_level,
    irls_sup,
    optical_flow_pyramid,
)
from tpuflow_torch.solvers.affine import (  # noqa: F401
    affine_flow_field,
    multiple_motion_affine,
)
from tpuflow_torch.solvers.black_anandan_fast import (  # noqa: F401
    optical_flow_pyramid_fast,
)
from tpuflow_torch.solvers.farneback import (  # noqa: F401
    calc_optical_flow_farneback,
)
from tpuflow_torch.solvers.lucas_kanade import (  # noqa: F401
    accept_tracked_point,
    dense_lucas_kanade,
    good_features_to_track,
    track_points,
)
from tpuflow_torch.solvers.bm_flow import (  # noqa: F401
    affine_parametric_flow,
    gradient_method_flow,
    optical_flow_block_matching,
    optical_flow_block_matching_async,
)
from tpuflow_torch.solvers.mestimators import (  # noqa: F401
    geman_mcclure_psi,
    geman_mcclure_rho,
    lorentzian_psi,
    lorentzian_rho,
)
