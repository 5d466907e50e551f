"""Audio decode for the port's CLIs (host side)."""
