"""Frame streams (counterpart of :mod:`tpuflow.pipeline`)."""
