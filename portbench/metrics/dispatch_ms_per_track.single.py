"""Host milliseconds a track that a call spends other than waiting for the
card: the host time of the traced window's root spans less the host time of
their ``host_read`` spans, over the roots' tracks."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    roots = spans.host_ms(recs, spans.ROOT)
    waits = spans.host_ms(spans.in_roots(recs), "host_read") or 0.0
    return spans.per(None if roots is None else roots - waits, spans.tracks(recs))
