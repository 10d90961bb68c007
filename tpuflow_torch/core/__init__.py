"""Border policies, configuration, color and resampling (counterpart of
:mod:`tpuflow.core`)."""
