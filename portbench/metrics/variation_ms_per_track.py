"""Device milliseconds a track of the tempo-variation check and refinement:
the stream time of its ``grid.variation`` spans over the traced window's
tracks."""

from portbench.spans import stream_ms_per_track

read = stream_ms_per_track("grid.variation")
