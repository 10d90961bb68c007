"""Host ms a frame spends blocked on the card, read from the program's own
spans of the traced window (``tpuflow_torch.utils.telemetry.spans()``):
the ``wait.*`` spans around each ``.item()``, ``.tolist()``, blocking copy
and event wait. A checkout whose program records no spans reads nothing."""

LAYER = "host drivers: streaming, bm_flow, black_anandan"
UNIT = "ms/frame"
MOVES = "frames_per_s"


def program_spans():
    """The program's spans of the traced window, or None where it records
    none."""
    from tpuflow_torch.utils import telemetry

    read = getattr(telemetry, "spans", None)
    return (read() or None) if read is not None else None


def is_wait(span) -> bool:
    return span.name.startswith("wait.")


def host_ms_less_waits(spans, names) -> float | None:
    """Host ms of the spans named in ``names`` less the ``wait.*`` spans
    beneath them; None where no span has such a name."""
    chosen = {s.index for s in spans if s.name in names}
    if not chosen:
        return None
    total = sum(spans[i].host_ms for i in chosen)
    for s in filter(is_wait, spans):
        up = s.parent
        while up is not None and up not in chosen:
            up = spans[up].parent
        if up is not None:
            total -= s.host_ms
    return total


def read(ctx):
    spans = program_spans()
    if spans is None:
        return None
    return sum(s.host_ms for s in spans if is_wait(s)) / ctx["steps"]
