"""IRLS sweeps a Black-Anandan frame ran over all levels: the port's
``blocks`` counts times ``fuse``, averaged over the traced frames. The work
the stop test left."""

LAYER = "BA pyramid: black_anandan_fast, black_anandan"
UNIT = "sweeps/frame"
MOVES = "frames_per_s"


def read(ctx):
    sweeps = ctx["extras"].get("ba_sweeps")
    if not sweeps:
        return None
    return sum(sweeps) / len(sweeps)
