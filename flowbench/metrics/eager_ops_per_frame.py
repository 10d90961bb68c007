"""ATen ops a frame dispatches on tensors of the card, counted from the
benchmark's side with a ``TorchDispatchMode`` over the counting steps after
the traced window. The hand-written kernels go through ctypes and are not
ATen ops; their output allocations are."""

LAYER = "host drivers: streaming, bm_flow, black_anandan"
UNIT = "ops/frame"
MOVES = "frames_per_s"


def read(ctx):
    if ctx["ops"] <= 0:
        return None
    return ctx["ops"] / ctx["count_steps"]
