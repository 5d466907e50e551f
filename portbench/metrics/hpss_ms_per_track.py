"""Device milliseconds a track of the port's HPSS decomposition (ten
iterations of the two masked medians) inside the pipeline: the stream time
of its ``hpss.decompose`` spans over the traced window's tracks. The
benchmark-side ``hpss_decompose_ms_per_track`` times the same work from
outside."""

from portbench.spans import stream_ms_per_track

read = stream_ms_per_track("hpss.decompose")
