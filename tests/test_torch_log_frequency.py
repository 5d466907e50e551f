"""The ``log-frequency`` configuration of the benchmark (``portbench/configs/
log-frequency.json``: the upstream's semitone-bin key chroma in place of its
HPCP) on the CPU: the port against the benchmark's plain reference; the
semitone projection against a direct evaluation of its interpolation; the
``key.log_frequency`` span and the ``key_stft_bins`` counter, and the readers
of the cell's per-layer metrics; the control against the cell's limits.
Imports no JAX, so that its ``cuda`` test runs on the card with the conftest
left out: ``python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_log_frequency.py``."""

import json
import math
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import stratum_dsp_tpu_torch as port
from portbench import compare, harness, reference, roofline, synth, traffic
from portbench.reference.plain.features.chroma import extractor as plain_chx
from stratum_dsp_tpu_torch import measure, testing, tracing
from stratum_dsp_tpu_torch.features.chroma import extractor as chx

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
CONFIG = json.loads((BENCH / "configs" / "log-frequency.json").read_text())
LIMITS = json.loads((BENCH / "limits" / "log-frequency.adversarial.json").read_text())["limits"]
LOG_FREQ = port.AnalysisConfig.from_dict(CONFIG["analysis_config"])
SR, FFT, HOP = 44100, 8192, 512  # the key STFT
ALL_BINS, KEEP = FFT // 2 + 1, 931  # the bins kept under log-frequency and under the default
ROOFLINE = "polyphase_stage2.log-frequency_roofline"
READERS = ("key_log_frequency_ms_per_track", "key_stft_bins_per_pass", ROOFLINE)


def test_config_file_is_the_measured_opt_in_config():
    assert CONFIG["analysis_config"] == measure.OPT_IN_CONFIGS["log-frequency"]["overrides"]
    assert LOG_FREQ.enable_key_log_frequency and not LOG_FREQ.enable_key_hpcp
    assert CONFIG["batch_size"] == 40 and CONFIG["sample_rate"] == SR
    assert CONFIG["reduced"] == []


def _batch(n=3, seconds=8.0, seed=19, device="cpu"):
    """``n`` tracks of the cell's mix (``portbench/traffic/adversarial.json``)
    at ``seconds`` each, made on ``device``."""
    mix = json.loads((BENCH / "traffic" / "adversarial.json").read_text())
    specs = traffic.draw_specs(dict(mix, track_seconds=seconds), n, np.random.default_rng(seed))
    t = int(seconds * synth.SAMPLE_RATE)
    return synth.tracks(specs, t, device), torch.full((n,), t, dtype=torch.int64, device=device)


def test_port_equals_the_plain_reference_under_log_frequency():
    """Every discrete output exactly; every float (BPM and beat times
    apart, which the comparison holds to their own gaps) within the cell's
    limit of ``score_gap_p50``."""
    x, n = _batch()
    got = {k: v.numpy() for k, v in port.analyze_batch(
        x, n, LOG_FREQ, SR, port.PipelineCaps(**CONFIG["pipeline_caps"]), device="cpu").items()}
    ref = reference.analyze(x, n, CONFIG, SR)
    assert set(got) == set(ref)
    for k in ref:
        if ref[k].dtype.kind == "f" and k not in ("bpm", "beat_times", "downbeat_times"):
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=LIMITS["score_gap_p50"],
                                       err_msg=k)
        elif ref[k].dtype.kind != "f":
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    tally = compare.Tally()
    compare.add_batch(tally, got, ref)
    correct, checks = compare.judge(tally.numbers(), LIMITS)
    assert correct and checks["decision_mismatch_pct"]["value"] == 0.0, checks


def _direct_projection(fmin=100.0, fmax=5000.0) -> np.ndarray:
    """The upstream's linear -> semitone-bin conversion (extractor.rs:701-807)
    evaluated bin by bin in float64: a bin at ``f`` in ``[fmin, fmax)`` adds
    its magnitude to the semitone bins on either side of ``12 log2(f / 440) +
    57``, by linear interpolation, counted from the floor of ``fmin``'s
    semitone."""
    lo_semi = math.floor(12.0 * math.log2(fmin / 440.0) + 57.0)
    n_out = math.ceil(12.0 * math.log2(fmax / 440.0) + 57.0) - lo_semi + 1
    w = np.zeros((ALL_BINS, n_out))
    for k in range(ALL_BINS):
        f = k * SR / FFT
        if not fmin <= f < fmax:
            continue
        pos = 12.0 * math.log2(f / 440.0) + 57.0 - lo_semi
        lo, frac = math.floor(pos), pos - math.floor(pos)
        w[k, lo] += 1.0 - frac
        if frac > 0.0:
            w[k, min(lo + 1, n_out - 1)] += frac
    return w


def test_log_frequency_projection_against_a_direct_evaluation():
    """The port's and the reference's matrices are one, within float32 of the
    direct evaluation; its rows are zero for every bin at or above 5 kHz (and
    below 100 Hz), so only bins below the default's 931 reach any output."""
    proj, s_min = chx.log_frequency_projection(SR, FFT, 100.0, 5000.0)
    plain, plain_min = plain_chx.log_frequency_projection(SR, FFT, 100.0, 5000.0)
    np.testing.assert_array_equal(proj, plain)
    want = _direct_projection()
    assert proj.shape == want.shape and proj.dtype == np.float32
    assert s_min == plain_min == math.floor(12.0 * math.log2(100.0 / 440.0) + 57.0)
    np.testing.assert_allclose(proj, want, rtol=0, atol=1e-6)
    freqs = np.arange(ALL_BINS) * SR / FFT
    used = np.flatnonzero(proj.any(axis=1))
    np.testing.assert_array_equal(used, np.flatnonzero((freqs >= 100.0) & (freqs < 5000.0)))
    assert not proj[freqs >= 5000.0].any() and used[-1] == 928 < KEEP
    np.testing.assert_allclose(proj[used].sum(axis=1), 1.0, rtol=0, atol=1e-6)
    fold = chx.semitone_fold_matrix(proj.shape[1], s_min)
    np.testing.assert_array_equal(fold, plain_chx.semitone_fold_matrix(proj.shape[1], s_min))
    assert [int(np.flatnonzero(r)[0]) for r in fold] == [(s_min + i) % 12
                                                           for i in range(proj.shape[1])]


def _recorded(cfg):
    x = testing.kick_patterns([120.0, 172.0], 8.0)
    port.reset_launch_counts()
    with tracing.recording():
        port.analyze_batch(x, [x.shape[1]] * 2, cfg, device="cpu")
    return tracing.spans()


@pytest.fixture(scope="module")
def recordings():
    return {"log-frequency": _recorded(LOG_FREQ), "default": _recorded(port.AnalysisConfig())}


@pytest.mark.parametrize("name,bins", [("log-frequency", ALL_BINS), ("default", KEEP)])
def test_key_stft_bins_and_log_frequency_spans(recordings, name, bins):
    recs = recordings[name]
    byid = {r["id"]: r for r in recs}
    counted = [r for r in recs if r["counts"].get("key_stft_passes")]
    assert [r["name"] for r in counted] == ["key.stft"]
    assert [r["counts"]["key_stft_bins"] for r in counted] == [bins]
    assert sum(r["counts"].get("key_stft_bins", 0) for r in recs) == bins
    lf = [r for r in recs if r["name"] == "key.log_frequency"]
    if name == "default":
        assert lf == []
        return
    assert len(lf) == counted[0]["counts"]["key_stft_chunks"] >= 1  # one a chunk
    assert all(byid[r["parent"]]["name"] == "key.stft" and r["attrs"] == {} for r in lf)
    assert not [r for r in recs if r["name"] == "key.hpcp"]


def _ctx(summary=None, durations=(180.0,) * 40, cfg=LOG_FREQ):
    run = SimpleNamespace(port_cfg=cfg, sample_rate=SR)
    window = {"attempted": len(durations),
              "outputs": [{"duration_seconds": np.asarray(durations)}]}
    return SimpleNamespace(run=run, summary=summary, window=window)


def _rec(i, name, parent, stream_ms=None, call=1, counts=None, **attrs):
    return {"id": i, "name": name, "parent": parent, "call": call, "thread": 1,
            "start_ns": i, "end_ns": i + 1, "host_ms": 1.0, "stream_ms": stream_ms,
            "counts": counts or {}, "attrs": attrs}


def _hand_made(bins=ALL_BINS):
    """Two calls of 40 tracks, each one key STFT pass of ``bins`` bins in
    two chunks."""
    recs = []
    for call in (1, 2):
        base = 10 * call
        recs += [_rec(base, "analyze", None, 1000.0, call, tracks=40),
                 _rec(base + 1, "key", base, 600.0, call),
                 _rec(base + 2, "key.stft", base + 1, 300.0, call,
                      {"key_stft_passes": 1, "key_stft_bins": bins, "key_stft_chunks": 2}),
                 _rec(base + 3, "key.log_frequency", base + 2, 20.0, call),
                 _rec(base + 4, "key.log_frequency", base + 2, 30.0, call)]
    return recs


def _spans_are(monkeypatch, recs):
    monkeypatch.setattr(tracing, "spans", lambda: [dict(r) for r in recs])


def test_readers_on_hand_made_spans(monkeypatch):
    _spans_are(monkeypatch, _hand_made())
    summary = {"device_s_by_name": {"polyphase_stage2_kernel": 0.5}}
    read = harness.load_reader
    assert read("key_log_frequency_ms_per_track")(_ctx()) == pytest.approx(100.0 / 80)
    assert read("key_stft_bins_per_pass")(_ctx()) == ALL_BINS
    frames = [(int(180.0 * SR) - FFT) // HOP + 1] * 40
    b, o = roofline.polyphase_work(frames, FFT // HOP, ALL_BINS)
    want = 100.0 * roofline.least_seconds(b, o) / 0.5
    assert read(ROOFLINE)(_ctx(summary)) == pytest.approx(want, rel=1e-12)
    # spans without the counters or stream times, or a window without the
    # kernel, read nothing
    _spans_are(monkeypatch, [dict(r, counts={}, stream_ms=None) for r in _hand_made()])
    for name in READERS:
        assert read(name)(_ctx(summary)) is None, name
    _spans_are(monkeypatch, _hand_made())
    assert read(ROOFLINE)(_ctx()) is None
    assert read(ROOFLINE)(_ctx({"device_s_by_name": {"other_kernel": 0.5}})) is None


def test_roofline_reads_the_bins_from_the_counter(monkeypatch):
    """At the default's 931 bins counted, the reader reads what the accepted
    ``polyphase_stage2_roofline`` reads from the default configuration; at
    4097 it counts the wider work of the same frames, whatever the
    configuration says."""
    summary = {"device_s_by_name": {"polyphase_stage2_kernel": 0.25}}
    default = port.AnalysisConfig()
    one = harness.load_reader("polyphase_stage2_roofline")(_ctx(summary, cfg=default))
    _spans_are(monkeypatch, _hand_made(KEEP))
    assert harness.load_reader(ROOFLINE)(_ctx(summary)) == pytest.approx(one, rel=1e-12)
    _spans_are(monkeypatch, _hand_made(ALL_BINS))
    wide = harness.load_reader(ROOFLINE)(_ctx(summary, cfg=default))
    assert 4.0 < wide / one < 4.5


@pytest.mark.parametrize("name,bins", [("log-frequency", float(ALL_BINS)),
                                       ("default", float(KEEP))])
def test_readers_on_a_recorded_cpu_call(recordings, monkeypatch, name, bins):
    """The bins counter reads on the CPU; the stream times and the kernel's
    device time do not exist there."""
    _spans_are(monkeypatch, recordings[name])
    assert harness.load_reader("key_stft_bins_per_pass")(_ctx()) == bins
    for reader in ("key_log_frequency_ms_per_track", ROOFLINE):
        assert harness.load_reader(reader)(_ctx()) is None, reader


@pytest.mark.parametrize("name", READERS)
def test_readers_read_none_without_the_tracer(name, monkeypatch):
    """A parent checkout's port without ``tracing``."""
    monkeypatch.delattr(port, "tracing")
    monkeypatch.setitem(sys.modules, "stratum_dsp_tpu_torch.tracing", None)
    summary = {"device_s_by_name": {"polyphase_stage2_kernel": 0.25}}
    assert harness.load_reader(name)(_ctx(summary)) is None


def test_control_fails_the_cells_limits():
    """The reference in bfloat16 products moves the scores past the cell's
    limit of ``score_gap_p50``."""
    x, n = _batch()
    ref = reference.analyze(x, n, CONFIG, SR)
    with reference.lower_precision():
        low = reference.analyze(x, n, CONFIG, SR)
    tally = compare.Tally()
    compare.add_batch(tally, low, ref)
    correct, checks = compare.judge(tally.numbers(), LIMITS)
    assert not correct
    assert checks["score_gap_p50"]["value"] > LIMITS["score_gap_p50"]


@pytest.mark.cuda
def test_every_sync_of_log_frequency_lies_in_a_host_read_on_card():
    """Under the card's sync debug mode, each synchronizing call of a warm
    40 x 180 s log-frequency batch lies inside a ``host_read``; the batch is
    within the cell's limits of the plain reference on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync debug mode watches the card")
    dev = torch.device("cuda:0")
    x, n = _batch(n=40, seconds=180.0, seed=1901, device=dev)
    outside, inside = [], 0

    def seen(message, category, filename, lineno, file=None, line=None):
        nonlocal inside
        if "synchronizing CUDA operation" not in str(message):
            return
        open_span = tracing._OPEN.get()
        if open_span is not None and open_span.name == "host_read":
            inside += 1
        else:
            outside.append(open_span.name if open_span else None)

    port.analyze_batch(x, n, LOG_FREQ, SR, device=dev)
    torch.cuda.synchronize()
    with warnings.catch_warnings(), tracing.recording():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = port.analyze_batch(x, n, LOG_FREQ, SR, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert inside > 0 and outside == [], sorted(set(map(str, outside)))
    ref = reference.analyze(x, n, CONFIG, SR)
    tally = compare.Tally()
    compare.add_batch(tally, {k: v.cpu().numpy() for k, v in out.items()}, ref)
    assert compare.judge(tally.numbers(), LIMITS)[0], tally.numbers()
