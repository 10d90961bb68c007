"""Border policies and configuration (counterpart of :mod:`tpuflow.core`)."""
