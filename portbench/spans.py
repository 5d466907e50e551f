"""What the per-layer readers of the port's own spans share: the records of
``stratum_dsp_tpu_torch.tracing`` for the traced window, and the sums the
readers take of them.

The harness resets the tracer (``reset_launch_counts``) just before the
window and the profiler turns recording on only inside it, so the records
read after the window are the window's. A counter is summed over the
counts attached to those spans, never taken from the tracer's process-wide
table, so that what the benchmark's own readers run after the window counts
for nothing. Every function returns None where there is nothing to read: a
port without the tracer, a window without the span, a stream time off a
card.
"""

from __future__ import annotations

ROOT = "analyze"


def recorded():
    """The window's span records, or None where the port has no tracer or
    recorded nothing."""
    try:
        from stratum_dsp_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans() or None


def named(recs, *names) -> list:
    return [r for r in recs if r["name"] in names]


def tracks(recs) -> int:
    """The tracks of the window's root spans."""
    return sum(int(r["attrs"].get("tracks", 0)) for r in named(recs, ROOT))


def counted(recs, counter: str) -> int:
    return sum(int(r["counts"].get(counter, 0)) for r in recs)


def stream_ms(recs, *names):
    """The summed stream ms of the spans named so, or None where none ran
    or one has no stream time (off a card)."""
    hits = named(recs, *names)
    if not hits or any(r["stream_ms"] is None for r in hits):
        return None
    return sum(r["stream_ms"] for r in hits)


def host_ms(recs, *names):
    hits = named(recs, *names)
    return sum(r["host_ms"] for r in hits) if hits else None


def in_roots(recs) -> list:
    """The spans of the calls that the window's root spans opened."""
    calls = {r["call"] for r in named(recs, ROOT)}
    return [r for r in recs if r["call"] in calls]


def per(value, base):
    """``value / base``, or None where either is missing or the base is 0."""
    if value is None or not base:
        return None
    return value / base


def stream_ms_per_track(*names):
    """A reader of the named stages' stream ms over the window's tracks."""
    def read(ctx):
        recs = recorded()
        return None if recs is None else per(stream_ms(recs, *names), tracks(recs))

    return read
