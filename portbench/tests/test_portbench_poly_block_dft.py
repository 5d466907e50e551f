"""The readers of the key STFT's stage-1 kernel's metrics:
``poly_block_dft_kernel_share`` from the port's counters,
``poly_block_dft_roofline`` from each track's key frames, the counted bins
and passes, and the kernel's device time."""

from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, roofline
from portbench.reference.plain.config import AnalysisConfig
from stratum_dsp_tpu_torch import tracing

SR, FFT, HOP, R = 44100, 8192, 512, 16
KERNEL = "void__anonymous_namespace_::poly_block_dft_kernel_4___anonymous_"
S_KERNEL = "void__anonymous_namespace_::stft_magnitude_kernel_4___anonymous_"
A_KERNEL = "void__anonymous_namespace_::polyphase_stage2_kernel_16_"


def _span(sid, name, counts=None, call=1, tracks=None):
    attrs = {} if tracks is None else {"tracks": tracks}
    return {"id": sid, "name": name, "parent": None, "call": call, "thread": 1,
            "start_ns": sid, "end_ns": sid + 1, "host_ms": 1.0, "stream_ms": 1.0,
            "counts": counts or {}, "attrs": attrs}


def _key_spans(kernel=True, bins=931, passes=1):
    """Two calls of 40 tracks, each ``passes`` key STFT passes of 81 chunks
    at ``bins`` bins (the tuning pass on ``key.tuning``), and a third call
    whose root span lies outside the window."""
    def counts(chunks):
        c = {"key_stft_passes": 1, "key_stft_bins": bins, "key_stft_chunks": chunks}
        return dict(c, poly_chunks=chunks, poly_block_dft=chunks) if kernel else c

    recs = []
    for call in (1, 2):
        recs.append(_span(10 * call, "analyze", call=call, tracks=40))
        if passes == 2:
            recs.append(_span(10 * call + 1, "key.tuning", counts(81), call=call))
        recs.append(_span(10 * call + 2, "key.stft", counts(81), call=call))
    recs.append(_span(40, "key.stft", counts(9), call=3))
    return recs


@pytest.mark.parametrize("kernel", [True, False], ids=["change", "parent"])
def test_poly_block_dft_kernel_share(monkeypatch, kernel):
    recs = _key_spans(kernel, passes=2)
    monkeypatch.setattr(tracing, "spans", lambda: [dict(r) for r in recs])
    read = harness.load_reader("poly_block_dft_kernel_share")
    assert read(None) == (1.0 if kernel else None)
    if kernel:
        recs[1]["counts"] = dict(recs[1]["counts"], poly_block_dft=0)  # a pass on the plain path
        assert read(None) == pytest.approx(3 * 81 / (4 * 81))


def _ctx(outputs, summary, cfg=None):
    run = SimpleNamespace(port_cfg=cfg or AnalysisConfig(), sample_rate=SR)
    return SimpleNamespace(run=run, summary=summary, window={"outputs": outputs})


def _frames(durations):
    return [(int(round(d * SR)) - FFT) // HOP + 1 for d in durations]


@pytest.mark.parametrize("bins,passes", [(931, 1), (4097, 1), (931, 2)])
def test_poly_block_dft_roofline_counts_each_tracks_blocks_once(monkeypatch, bins, passes):
    """The same tracks in one batch or in two read the same; the reading is
    the passes times the least time of the tracks' blocks at the counted
    bins, over the kernel's device time; a track shorter than a frame counts
    nothing."""
    monkeypatch.setattr(tracing, "spans", lambda: _key_spans(bins=bins, passes=passes))
    read = harness.load_reader("poly_block_dft_roofline")
    g = np.random.default_rng(7)
    durations = np.concatenate([g.uniform(150.0, 200.0, 39), [0.1]])
    summary = {"device_s_by_name": {KERNEL: 0.05, S_KERNEL: 1.0, A_KERNEL: 1.0}}
    one = read(_ctx([{"duration_seconds": durations}], summary))
    two = read(_ctx([{"duration_seconds": durations[:15]},
                     {"duration_seconds": durations[15:]}], summary))
    assert one == pytest.approx(two, rel=1e-12) and 0 < one < 100
    blocks = sum(f + R - 1 for f in _frames(durations[:39]))
    cols = 2 * (bins + 1)
    n_bytes, n_ops = 4 * blocks * HOP + 2 * blocks * cols, 2 * blocks * HOP * cols
    least = max(n_bytes / roofline.H100_BYTES_PER_S, n_ops / 989e12)
    assert one == pytest.approx(100.0 * passes * least / 0.05, rel=1e-9)


def test_poly_block_dft_roofline_reads_none_without_the_kernel(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: _key_spans(kernel=False))
    read = harness.load_reader("poly_block_dft_roofline")
    outputs = [{"duration_seconds": np.full(4, 180.0)}]
    assert read(_ctx(outputs, None)) is None
    parent = {"device_s_by_name": {"void_cutlass::Kernel2_cutlass_80_simt_sgemm_256x128": 0.5,
                                   S_KERNEL: 0.2, A_KERNEL: 0.1}}
    assert read(_ctx(outputs, parent)) is None
    monkeypatch.setattr(tracing, "spans", lambda: [])  # nothing counted the passes or bins
    assert read(_ctx(outputs, {"device_s_by_name": {KERNEL: 0.05}})) is None


@pytest.mark.parametrize("reader", ["stft_dft_roofline", "polyphase_stage2_roofline"])
def test_s_and_a_readers_do_not_match_the_new_kernel(reader):
    """S's and A's readers match by substring: stage 1's symbol holds
    neither, so its time never counts as theirs."""
    outputs = [{"duration_seconds": np.full(4, 180.0), "multi_res_triggered": np.zeros(4, bool)}]
    read = harness.load_reader(reader)
    assert read(_ctx(outputs, {"device_s_by_name": {KERNEL: 0.05}})) is None
