"""Kernel #2 (``irls_sweeps_kernel``): the frozen ``irls_bound`` of the
sweeps each level actually ran, over the kernel's device time in the traced
window, against the H100 SXM peaks (67 TFLOP/s float32, 3.35 TB/s)."""

from flowbench.harness import kernel_s

LAYER = "sweep kernels: irls_stencil, csrc/irls_stencil.cu"
UNIT = "%"
MOVES = "frames_per_s"


def read(ctx):
    bound = ctx["extras"].get("irls_bound_s")
    t = kernel_s(ctx["trace"], "irls_sweeps_kernel")
    if not bound or t <= 0.0:
        return None
    return 100.0 * bound / t
