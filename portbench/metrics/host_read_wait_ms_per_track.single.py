"""Host milliseconds a track that a call waits for the card: the host time of
the ``host_read`` spans of the traced window's calls over their tracks."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None or not spans.named(recs, spans.ROOT):
        return None
    waits = spans.host_ms(spans.in_roots(recs), "host_read") or 0.0
    return spans.per(waits, spans.tracks(recs))
