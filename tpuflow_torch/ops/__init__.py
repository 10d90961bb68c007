"""L1 image ops (counterpart of :mod:`tpuflow.ops`)."""
