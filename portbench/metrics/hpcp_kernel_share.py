"""Launches of the HPCP kernel (``hpcp_kernel``, counted at each launch on
the open ``key.hpcp`` span) over the ``key.hpcp`` spans not marked ``exact``
in the traced window's calls: 1 where every bisection HPCP ran as one
kernel, 0 on a port that picks those peaks without it. None where no such
span ran (a port without the span, or the sort's peaks)."""

from portbench import spans


def read(ctx):
    recs = spans.recorded()
    if recs is None:
        return None
    hits = [r for r in spans.named(spans.in_roots(recs), "key.hpcp")
            if r["attrs"].get("exact") is False]
    return spans.per(spans.counted(hits, "hpcp_kernel"), len(hits))
