"""Host ms a flagship frame spends issuing the region matcher's search:
the ``bm.search`` spans of the traced window (the plan, the ~700 candidate
chunks a strip set, the argmin and subpixel refine of both directions)
less the ``wait.*`` spans within them."""

from flowbench.metrics.host_wait_ms_per_frame import (host_ms_less_waits,
                                                      program_spans)

LAYER = "region matcher: blockmatching/matcher.py"
UNIT = "ms/frame"
MOVES = "frames_per_s"


def read(ctx):
    spans = program_spans()
    host = None if spans is None else host_ms_less_waits(spans,
                                                         ("bm.search",))
    return None if host is None else host / ctx["steps"]
