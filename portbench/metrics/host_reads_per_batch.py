"""Points a call where the host waits for the card (``host_read`` spans: reads
of device tensors and copies from pageable memory), counted on the spans of
the traced window's calls, over those calls."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    return spans.per(spans.counted(spans.in_roots(recs), "host_reads"),
                     len(spans.named(recs, spans.ROOT)))
