"""Megabytes a track copied from host memory to the card (``h2d_bytes``,
counted on the spans of the traced window's calls) over their tracks."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    return spans.per(spans.counted(spans.in_roots(recs), "h2d_bytes") / 1e6, spans.tracks(recs))
