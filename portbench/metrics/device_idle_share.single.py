"""The device's idle share of the traced window (per cent)."""

from portbench.layers import idle_share_pct as read  # noqa: F401
