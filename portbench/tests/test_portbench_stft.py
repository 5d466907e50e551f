"""The readers of the direct DFT kernel's metrics: ``stft_kernel_share``
from the port's counters, ``stft_dft_roofline`` from each track's frames and
the kernel's device time."""

import importlib.util
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness
from portbench.reference.plain.config import AnalysisConfig
from stratum_dsp_tpu_torch import tracing

SR = 44100
KERNEL = "void (anonymous namespace)::stft_magnitude_kernel<4>((anonymous namespace)::Args)"


def _span(sid, name, counts=None, call=1, tracks=None):
    attrs = {} if tracks is None else {"tracks": tracks}
    return {"id": sid, "name": name, "parent": None, "call": call, "thread": 1,
            "start_ns": sid, "end_ns": sid + 1, "host_ms": 1.0, "stream_ms": 1.0,
            "counts": counts or {}, "attrs": attrs}


@pytest.mark.parametrize("kernel", [True, False], ids=["change", "parent"])
def test_stft_kernel_share(monkeypatch, kernel):
    """Two calls: base chunks on ``bpm_features``, hop-256 chunks on
    ``multires.hop256``; the parent counts nothing."""
    def counts(n):
        return {"stft_chunks": n, "stft_kernel": n} if kernel else {}

    recs = [_span(1, "analyze", tracks=40), _span(2, "bpm_features", counts(61)),
            _span(3, "multires.hop256", counts(122)), _span(4, "analyze", call=2, tracks=40),
            _span(5, "bpm_features", counts(61), call=2),
            _span(6, "bpm_features", {"stft_chunks": 9, "stft_kernel": 9}, call=3)]
    monkeypatch.setattr(tracing, "spans", lambda: [dict(r) for r in recs])
    read = harness.load_reader("stft_kernel_share")
    # call 3 has no root span in the window: its counts are not read
    assert read(None) == (1.0 if kernel else None)
    if kernel:
        recs[2]["counts"] = {"stft_chunks": 122}  # the hop-256 chunks on the plain path
        assert read(None) == pytest.approx(122 / 244)


def _reader_module():
    path = harness.HERE / "metrics" / "stft_dft_roofline.py"
    spec = importlib.util.spec_from_file_location("stft_dft_roofline", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ctx(outputs, summary):
    run = SimpleNamespace(port_cfg=AnalysisConfig(), sample_rate=SR)
    return SimpleNamespace(run=run, summary=summary, window={"outputs": outputs})


def test_stft_dft_roofline_counts_each_tracks_frames_once():
    """The same tracks in one batch or in two read the same; the reading is
    the least time of the work over the kernel's device time; the work of
    40 tracks of equal frames is ``bound_ms`` of one launch over them."""
    from stratum_dsp_tpu_torch.ops import stft

    g = np.random.default_rng(7)
    durations = g.uniform(150.0, 200.0, 40)
    trig = g.random(40) < 0.3
    summary = {"device_s_by_name": {KERNEL: 0.02, "other": 1.0}}
    read = harness.load_reader("stft_dft_roofline")
    one = read(_ctx([{"duration_seconds": durations, "multi_res_triggered": trig}], summary))
    two = read(_ctx([{"duration_seconds": durations[:15], "multi_res_triggered": trig[:15]},
                     {"duration_seconds": durations[15:], "multi_res_triggered": trig[15:]}],
                    summary))
    assert one == pytest.approx(two, rel=1e-12) and 0 < one < 100
    mod = _reader_module()
    frames = 15000
    samples = (frames - 1) * 512 + 2048
    n_bytes, n_ops = mod.work([frames] * 40, 2048, 512, 1025)
    want = stft.stft_magnitude_bound_ms(40, frames, 2048, 512, 1025)
    assert (n_bytes, n_ops) == (want["bytes"], want["operations"])
    got = read(_ctx([{"duration_seconds": np.full(40, samples / SR),
                      "multi_res_triggered": np.zeros(40, bool)}], summary))
    assert got == pytest.approx(100.0 * want["bound_ms"] / 1e3 / 0.02, rel=1e-9)


def test_stft_dft_roofline_reads_none_without_the_kernel():
    read = harness.load_reader("stft_dft_roofline")
    outputs = [{"duration_seconds": np.full(4, 180.0), "multi_res_triggered": np.zeros(4, bool)}]
    assert read(_ctx(outputs, None)) is None
    assert read(_ctx(outputs, {"device_s_by_name": {"cutlass_80_simt_sgemm": 0.5}})) is None
