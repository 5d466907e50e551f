"""Device milliseconds a track of the port's streamed BPM STFT and novelty
features (kernel D): the stream time of its ``bpm_features`` spans over the
traced window's tracks."""

from portbench.spans import stream_ms_per_track

read = stream_ms_per_track("bpm_features")
