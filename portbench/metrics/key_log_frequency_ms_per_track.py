"""Device milliseconds a track of the log-frequency key chroma (the
projection onto semitone bins, the fold into pitch classes, the L2
normalisation and the semitone bins' energy, once a key STFT chunk in the
reducer of ``extract_key_features``): the stream time of its
``key.log_frequency`` spans over the traced window's tracks. None where no
such span ran (a port without the span, or another key front end) or off a
card."""

from portbench.spans import stream_ms_per_track

read = stream_ms_per_track("key.log_frequency")
