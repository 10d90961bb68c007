"""Synchronising calls a frame makes, as PyTorch reports them with
``torch.cuda.set_sync_debug_mode("warn")`` (``.item()``, ``.tolist()``,
blocking copies to the host), over the counting steps after the traced
window. Event waits (``torch.cuda.Event.synchronize``) are not reported."""

LAYER = "host drivers: streaming, bm_flow, black_anandan"
UNIT = "syncs/frame"
MOVES = "frames_per_s"


def read(ctx):
    return ctx["syncs"] / ctx["count_steps"]
