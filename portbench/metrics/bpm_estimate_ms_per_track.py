"""Device milliseconds a track of the port's BPM estimate: the stream time
of its ``legacy`` (autocorrelation and comb), ``tempogram`` (the base
tempograms and the ambiguity gate) and ``select`` spans over the traced
window's tracks."""

from portbench.spans import stream_ms_per_track

read = stream_ms_per_track("legacy", "tempogram", "select")
