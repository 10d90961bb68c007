"""Share of the traced window in which no kernel, copy or set ran on the
card (torch.profiler's device activity; the union of op intervals)."""

LAYER = "device: one H100"
UNIT = "%"
MOVES = "frames_per_s"


def read(ctx):
    if ctx["trace"].busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - ctx["trace"].busy_s / ctx["window_s"])
