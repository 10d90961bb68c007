"""Utilities (counterpart of :mod:`tpuflow.utils`)."""
