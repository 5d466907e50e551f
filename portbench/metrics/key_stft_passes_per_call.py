"""Passes a call makes over the key STFT (``key_stft_passes``, counted by
``_stream_key_stft`` once a pass on the window's calls' spans) over the
traced window's calls. None where nothing counted them (a port without the
counter)."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    passes = spans.counted(spans.in_roots(recs), "key_stft_passes")
    return spans.per(passes, len(spans.named(recs, spans.ROOT))) if passes else None
