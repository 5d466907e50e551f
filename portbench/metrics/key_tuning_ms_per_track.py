"""Device milliseconds a track of the key path's tuning estimate (its own
pass of the key STFT with kernel A, the harmonic time-mask and the circular
sums, ``estimate_tuning_streamed``): the stream time of its ``key.tuning``
spans over the traced window's tracks."""

from portbench.spans import stream_ms_per_track

read = stream_ms_per_track("key.tuning")
