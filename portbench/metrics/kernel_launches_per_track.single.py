"""Kernels launched in the traced window per track answered in it."""

from portbench.layers import launches_per_track as read  # noqa: F401
