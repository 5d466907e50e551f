"""Device milliseconds a track of the bisection HPCP (``frames_to_hpcp`` with
its peaks picked by the bisection: the peak pick and the harmonic summation,
once a key STFT chunk): the stream time of the ``key.hpcp`` spans not marked
``exact`` over the traced window's tracks. None where no such span ran (a
port without the span, or the sort's peaks) or off a card."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    hits = [r for r in spans.named(recs, "key.hpcp") if r["attrs"].get("exact") is False]
    if not hits or any(r["stream_ms"] is None for r in hits):
        return None
    return spans.per(sum(r["stream_ms"] for r in hits), spans.tracks(recs))
