"""Device milliseconds an escalated track of the port's multi-resolution
escalation: the stream time of its ``escalate`` spans over the rows they
escalated (``escalated_rows``, counted on the window's spans); None where no
row escalated."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    return spans.per(spans.stream_ms(recs, "escalate"), spans.counted(recs, "escalated_rows"))
