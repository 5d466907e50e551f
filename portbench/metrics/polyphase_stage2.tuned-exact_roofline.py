"""Kernel A's share of its roofline over the traced window (per cent) where
a call streams the key STFT more than once: ``polyphase_stage2_roofline``'s
share, which counts one pass of stage 2 over every track's key STFT frames,
times the passes a call made (``key_stft_passes`` on the window's calls'
spans). None where the kernel ran in no launch of the window, or where
nothing counted the passes (a port without the counter)."""

from portbench import harness, spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    passes = spans.per(spans.counted(spans.in_roots(recs), "key_stft_passes"),
                       len(spans.named(recs, spans.ROOT)))
    one_pass = harness.load_reader("polyphase_stage2_roofline")(ctx)
    if not passes or one_pass is None:
        return None
    return passes * one_pass
