"""Host ms a frame spends working, not waiting, inside the program: its
top spans of the traced window (``bm.frame`` and ``bm.fetch`` of the
flagship, ``ba.frame`` of Black-Anandan) less the ``wait.*`` spans within
them. With ``host_wait_ms_per_frame`` it closes the frame: what the two
leave of the traced frame time is the driver's own and unspanned work."""

from flowbench.metrics.host_wait_ms_per_frame import (host_ms_less_waits,
                                                      program_spans)

LAYER = "host drivers: streaming, bm_flow, black_anandan"
UNIT = "ms/frame"
MOVES = "frames_per_s"

TOPS = ("bm.frame", "bm.fetch", "ba.frame")


def read(ctx):
    spans = program_spans()
    busy = None if spans is None else host_ms_less_waits(spans, TOPS)
    return None if busy is None else busy / ctx["steps"]
