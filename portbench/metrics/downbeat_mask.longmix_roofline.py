"""Kernel B's long path's share of its roofline over the traced window (per
cent): the least time an H100 could take for the window's downbeat walks,
over the device time of ``downbeat_long_kernel``. None where that kernel ran
in no launch of the window, or where nothing counted the slots (a port
without ``downbeat_slots``).

The work is that of ``bound_ms`` beside the wrapper
(``stratum_dsp_tpu_torch/ops/downbeats.py``), counted from the beats the
window's rows had (``downbeat_slots``: each row's ``n_beats``, summed on the
``grid.downbeats`` spans): each such slot's f32 time read once, a row's count
and bar length once, each row's one-byte mask written once for all
``max(max_segments x seg_beat_cap, max_beats)`` slots; six operations a beat.
The walk is a chain of one vote a window, so this share reads far below
1%."""

from portbench import roofline, spans, trace

KERNEL = "downbeat_long_kernel"


def work(beats: int, tracks: int, slots: int) -> tuple:
    """``(bytes, ops)`` of walking ``beats`` beats over ``tracks`` rows of
    ``slots`` slots in all."""
    return 4 * beats + 8 * tracks + tracks * slots, 6 * beats


def read(ctx):
    if ctx.summary is None:
        return None
    spent = trace.device_seconds(ctx.summary, KERNEL)
    recs = spans.recorded()
    if not spent or recs is None:
        return None
    beats = spans.counted(spans.in_roots(recs), "downbeat_slots")
    if not beats:
        return None
    caps = ctx.run.port_caps
    n_bytes, n_ops = work(beats, spans.tracks(recs),
                          max(caps.max_segments * caps.seg_beat_cap, caps.max_beats))
    return 100.0 * roofline.least_seconds(n_bytes, n_ops) / spent
