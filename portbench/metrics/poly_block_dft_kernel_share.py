"""Launches of the key STFT's stage-1 kernel (``poly_block_dft``, counted at
each launch on the open span) over the polyphase key STFT chunks
(``poly_chunks``, counted at each chunk on ``key.tuning``, ``key.hpss_mask``,
``key.stft`` or a mesh shard's span) in the traced window's calls: 1 where
every chunk's stage 1 ran as one launch of the kernel, less where some took
the plain path. None where no chunk was counted (a port without the
counters)."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    calls = spans.in_roots(recs)
    return spans.per(spans.counted(calls, "poly_block_dft"), spans.counted(calls, "poly_chunks"))
