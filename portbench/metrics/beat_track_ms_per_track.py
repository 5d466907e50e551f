"""Device milliseconds a track of the HMM beat tracking (emissions, kernel C's
Viterbi decode, the grid fill): the stream time of its ``grid.track`` spans
over the traced window's tracks."""

from portbench.spans import stream_ms_per_track

read = stream_ms_per_track("grid.track")
