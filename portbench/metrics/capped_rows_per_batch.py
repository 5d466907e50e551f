"""Rows a call that a capacity of ``PipelineCaps`` cut (onsets of any method,
beat slots or tempo-variation segments; ``capped_rows`` on the window's
calls' spans) over the calls. None where the port does not count them: a
window without the ``grid.variation`` span, at whose one host read the count
is taken."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None or not spans.named(recs, "grid.variation"):
        return None
    return spans.per(spans.counted(spans.in_roots(recs), "capped_rows"),
                     len(spans.named(recs, spans.ROOT)))
