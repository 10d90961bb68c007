"""Frame streams, motion compensation and flow metrics (counterpart of
:mod:`tpuflow.pipeline`)."""

from tpuflow_torch.pipeline.metrics import angular_error, epe  # noqa: F401
