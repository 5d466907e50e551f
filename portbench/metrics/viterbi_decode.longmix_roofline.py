"""Kernel C's long path's share of its roofline over the traced window (per
cent): the least time an H100 could take for the window's Viterbi decodes,
over the device time of ``viterbi_long_kernel``. None where that kernel ran
in no launch of the window, or where nothing counted the frames (a port
without ``viterbi_frames``).

The work is that of ``bound_ms`` beside the wrapper
(``stratum_dsp_tpu_torch/ops/viterbi.py``), counted from the frames the
window's rows had to decode (``viterbi_frames``: each row's beat slots,
summed on the ``grid.track`` spans): each such frame's f32 emission read
once, the 5 x 5 f32 transitions once a call, each row's int32 states written
once for all ``max_beats`` slots; per frame and state three products, two
compares and the emission's product. The decode is a chain of dependent
steps, so this share reads far below 1%."""

from portbench import roofline, spans, trace

KERNEL = "viterbi_long_kernel"


def work(frames: int, calls: int, tracks: int, slots: int) -> tuple:
    """``(bytes, ops)`` of decoding ``frames`` frames over ``calls`` calls of
    ``tracks`` rows of ``slots`` slots in all."""
    return 4 * frames + 100 * calls + 4 * tracks * slots, 30 * frames


def read(ctx):
    if ctx.summary is None:
        return None
    spent = trace.device_seconds(ctx.summary, KERNEL)
    recs = spans.recorded()
    if not spent or recs is None:
        return None
    frames = spans.counted(spans.in_roots(recs), "viterbi_frames")
    if not frames:
        return None
    n_bytes, n_ops = work(frames, len(spans.named(recs, spans.ROOT)), spans.tracks(recs),
                          ctx.run.port_caps.max_beats)
    return 100.0 * roofline.least_seconds(n_bytes, n_ops) / spent
