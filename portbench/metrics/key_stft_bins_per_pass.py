"""Bins a pass over the key STFT keeps (``key_stft_bins``, counted by
``_stream_key_stft`` beside ``key_stft_passes`` on the window's calls'
spans) over the passes. None where nothing counted them (a port without
either counter)."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    calls = spans.in_roots(recs)
    return spans.per(spans.counted(calls, "key_stft_bins") or None,
                     spans.counted(calls, "key_stft_passes"))
