"""Device milliseconds a track of the port's preprocessing (normalization,
silence trim): the stream time of its ``preprocess`` spans over the traced
window's tracks (``stratum_dsp_tpu_torch.tracing``)."""

from portbench.spans import stream_ms_per_track

read = stream_ms_per_track("preprocess")
