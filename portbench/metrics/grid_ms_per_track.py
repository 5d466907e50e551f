"""Device milliseconds a track of the port's beat grid (phase search, grid,
downbeats, time signature, tempo variation): the stream time of its ``grid``
spans over the traced window's tracks."""

from portbench.spans import stream_ms_per_track

read = stream_ms_per_track("grid")
