"""Device ms a frame spends in kernels that no ``tpuflow_torch/csrc/*.cu``
defines (PyTorch's and cuBLAS's: the matcher's gathers and float64 GEMMs,
Lab and compose, the pyramid, warps, energies) and in copies and sets, over
the traced window."""

import re

LAYER = "eager PyTorch ops on the card"
UNIT = "ms/frame"
MOVES = "frames_per_s"


def read(ctx):
    trace = ctx["trace"]
    if trace.busy_s <= 0.0:
        return None
    own = re.compile(r"(^|[^\w])(" + "|".join(
        map(re.escape, sorted(ctx["program_kernels"]))) + r")\s*[<(]")
    eager = sum(s for name, s in trace.op_s.items() if not own.search(name))
    return 1e3 * eager / ctx["steps"]
