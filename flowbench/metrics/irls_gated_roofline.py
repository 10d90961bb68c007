"""Kernel #8 (``irls_gated_kernel``): the frozen ``gated_bound`` on each
refined frame's labels, for the sweeps its launches ran, over the kernel's
device time in the traced window. Nothing is read where the two directions
of a refine ran different sweeps (the launch count then does not say how
many ran two at a time)."""

from flowbench.harness import kernel_s

LAYER = "gated refine: bm_flow.irls_gradient_method, csrc/irls_gated.cu"
UNIT = "%"
MOVES = "frames_per_s"


def read(ctx):
    bound = ctx["extras"].get("gated_bound_s")
    t = kernel_s(ctx["trace"], "irls_gated_kernel")
    if not bound or t <= 0.0:
        return None
    return 100.0 * bound / t
