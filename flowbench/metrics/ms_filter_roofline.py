"""Kernel #11 (``ms_filter_kernel``): the frozen ``ms_bound`` with the
iterations each query needs, counted by ``ms_query_iterations``' rule on the
benchmark's own plain mean-shift of each frame filtered in the traced
window, over the kernel's device time there."""

from flowbench.harness import kernel_s

LAYER = "segmentation: meanshift, csrc/ms_filter.cu"
UNIT = "%"
MOVES = "frames_per_s"


def read(ctx):
    bound = ctx["extras"].get("ms_bound_s")
    t = kernel_s(ctx["trace"], "ms_filter_kernel")
    if not bound or t <= 0.0:
        return None
    return 100.0 * bound / t
