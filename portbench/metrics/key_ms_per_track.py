"""Device milliseconds a track of the port's key path (the key STFT with
kernel A, chroma, scoring): the stream time of its ``key`` spans over the
traced window's tracks."""

from portbench.spans import stream_ms_per_track

read = stream_ms_per_track("key")
