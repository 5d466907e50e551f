"""Launches of the direct DFT's kernel (``stft_kernel``, counted at each
launch on the open span) over the direct-form STFT chunks (``stft_chunks``,
counted at each chunk: the BPM STFT's, the hop-256 escalation's, the HPSS
spectrogram's) in the traced window's calls: 1 where every such chunk ran as
one launch of the kernel, less where some took the plain path. None where no
chunk was counted (a port without the counters)."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    calls = spans.in_roots(recs)
    return spans.per(spans.counted(calls, "stft_kernel"), spans.counted(calls, "stft_chunks"))
