"""Device milliseconds a track of the port's onset detection: the stream
time of its ``onsets`` (energy flux) and ``consensus`` (the spectral, HFC and
percussive fluxes and the vote) spans over the traced window's tracks."""

from portbench.spans import stream_ms_per_track

read = stream_ms_per_track("onsets", "consensus")
