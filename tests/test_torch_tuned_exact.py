"""The ``tuned-exact`` configuration of the benchmark (``portbench/configs/
tuned-exact.json``: the key path's tuning estimate and its exact HPCP peaks)
on the CPU: the port against the benchmark's plain reference, on A440 tracks
and on tracks pitched 6 cents sharp; the exact peak pick against a brute-force
one; the ``key.hpcp`` span and the key STFT's pass and chunk counters, and the
readers of the cell's per-layer metrics; the control against the cell's
limits. Imports no JAX, so that its ``cuda`` test runs on the card with the
conftest left out: ``python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_tuned_exact.py``."""

import json
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import stratum_dsp_tpu_torch as port
from portbench import compare, harness, reference, synth, traffic
from portbench.reference.plain.config import AnalysisConfig as PlainConfig
from portbench.reference.plain.features.key import pipeline as plain_key
from stratum_dsp_tpu_torch import testing, tracing
from stratum_dsp_tpu_torch.features.chroma import extractor as chx
from stratum_dsp_tpu_torch.features.key import pipeline as key_pipeline

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
CONFIG = json.loads((BENCH / "configs" / "tuned-exact.json").read_text())
LIMITS = json.loads((BENCH / "limits" / "tuned-exact.adversarial.json").read_text())["limits"]
TUNED = port.AnalysisConfig.from_dict(CONFIG["analysis_config"])
SR, FFT, KEEP = 44100, 8192, 931  # the key STFT and the bins it keeps
CENTS = 6.0


def _batch(n=3, seconds=8.0, seed=5):
    """``n`` tracks of the cell's mix (``portbench/traffic/adversarial.json``)
    at ``seconds`` each, made on the CPU."""
    mix = json.loads((BENCH / "traffic" / "adversarial.json").read_text())
    specs = traffic.draw_specs(dict(mix, track_seconds=seconds), n, np.random.default_rng(seed))
    t = int(seconds * synth.SAMPLE_RATE)
    return synth.tracks(specs, t, "cpu"), torch.full((n,), t, dtype=torch.int64)


def _pitched(x: torch.Tensor, cents: float) -> torch.Tensor:
    """``x`` played ``cents`` sharp: resampled by linear interpolation at
    ``2 ** (cents / 1200)`` times the rate, zeros past the end."""
    t = x.shape[1]
    at = np.arange(t) * 2.0 ** (cents / 1200.0)
    rows = [np.interp(at, np.arange(t), row, right=0.0) for row in x.numpy().astype(np.float64)]
    return torch.as_tensor(np.stack(rows).astype(np.float32))


def _port(x, n):
    return port.analyze_batch(x, n, TUNED, SR, port.PipelineCaps(**CONFIG["pipeline_caps"]),
                              device="cpu")


def _assert_equal(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)


def test_port_equals_the_plain_reference_under_tuned_exact():
    x, n = _batch()
    _assert_equal(_port(x, n), reference.analyze(x, n, CONFIG, SR))


def test_tuning_of_a_sharp_batch_equals_the_reference():
    """Six cents sharp: the estimate is the reference's, leans sharp, and the
    keys come out as on the reference (and as at A440)."""
    x, n = _batch()
    sharp = _pitched(x, CENTS)
    chunk = key_pipeline._auto_chunk(x.shape[0], FFT, 512)
    got = key_pipeline.estimate_tuning_streamed(sharp, n, TUNED, SR, chunk_frames=chunk)
    ref = plain_key.estimate_tuning_streamed(
        sharp, n, PlainConfig.from_dict(CONFIG["analysis_config"]), SR, chunk_frames=chunk)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)
    assert (got.abs() >= 0.03).all(), got
    assert (got > 0).all(), got
    out, ref_out = _port(sharp, n), reference.analyze(sharp, n, CONFIG, SR)
    _assert_equal(out, ref_out)
    np.testing.assert_array_equal(out["key_idx"].numpy(), _port(x, n)["key_idx"].numpy())


def _brute_force_hpcp(spec, tuning, peaks, sigma=0.5, harmonics=4, decay=0.6, power=0.5,
                      fmin=100.0, fmax=5000.0):
    """The upstream's HPCP of each frame (extractor.rs:582-680) in float64,
    one peak at a time: local maxima (higher than the left neighbour, no
    lower than the right) inside the band, the ``peaks`` largest with ties to
    the lower bin, each peak's harmonics spread over the three nearest
    pitch classes."""
    spec = spec.astype(np.float64)
    fres = SR / FFT
    n_bins = spec.shape[-1]
    out = np.zeros(spec.shape[:-1] + (12,))
    for idx in np.ndindex(spec.shape[:-1]):
        x = spec[idx]
        found = [i for i in range(1, n_bins - 1) if fmin <= i * fres <= fmax
                 and x[i] > x[i - 1] and x[i] >= x[i + 1]]
        kept = []
        if found:
            # torch.topk finds the K-th value; of the peaks equal to it, the
            # lower bins are kept
            vals = torch.as_tensor(np.asarray([x[i] for i in found]))
            kth = float(torch.topk(vals, min(peaks, len(found))).values[-1])
            kept = [i for i in found if x[i] > kth]
            kept += [i for i in found if x[i] == kth][:min(peaks, len(found)) - len(kept)]
        t = float(tuning[idx[0]]) if np.ndim(tuning) else float(tuning)
        for i in kept:
            f0 = i * fres
            for h in range(1, harmonics + 1):
                fh = f0 * h
                if not (fmin <= fh <= fmax):
                    continue
                pc = np.mod(12.0 * np.log2(fh / 440.0) + 57.0 - t, 12.0)
                primary = np.mod(np.round(pc), 12.0)
                for off in (-1.0, 0.0, 1.0):
                    cls = np.mod(primary + off, 12.0)
                    d = abs(pc - cls)
                    d = min(d, 12.0 - d)
                    out[idx + (int(cls),)] += (np.exp(-d * d / (2 * sigma * sigma))
                                               * decay ** (h - 1) / h * x[i] ** power)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return np.where(norm > 0, out / np.where(norm > 0, norm, 1.0), 0.0)


@pytest.mark.parametrize("band", [(100.0, 5000.0), (100.0, 140.0)], ids=["key-band", "narrow"])
@pytest.mark.parametrize("tuning", [0.0, "per-track"])
def test_exact_hpcp_equals_a_brute_force_peak_pick(band, tuning):
    """Magnitudes on eight levels, so that peaks tie at the K-th often; the
    narrow band asks for more peaks than half its bins (the plain top-k)."""
    rng = np.random.default_rng(151)
    spec = (rng.integers(0, 8, (2, 6, KEEP)) / 8.0).astype(np.float32)
    spec[0, 0] = 0.0  # a frame without peaks stays zero
    t = torch.as_tensor([0.05, -0.07]) if tuning == "per-track" else 0.0
    got = chx.frames_to_hpcp(torch.as_tensor(spec), SR, FFT, 0.5, t, 24, 4, 0.6, 0.5,
                             fmin_hz=band[0], fmax_hz=band[1], approx_peaks=False)
    want = _brute_force_hpcp(spec, t.numpy() if torch.is_tensor(t) else t, 24,
                             fmin=band[0], fmax=band[1])
    assert not got[0, 0].any()
    # float32 semitone positions (~50) are 3.8e-6 apart, and a class weight
    # moves by up to 6 times its position's error (d / sigma^2 at d = 1.5); a
    # peak picked otherwise moves the classes by 1e-2 and more
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-5)


def _recorded(cfg):
    x = testing.kick_patterns([120.0, 172.0], 8.0)
    port.reset_launch_counts()
    with tracing.recording():
        port.analyze_batch(x, [x.shape[1]] * 2, cfg, device="cpu")
    return tracing.spans()


@pytest.fixture(scope="module")
def recordings():
    return {"tuned-exact": _recorded(TUNED), "default": _recorded(port.AnalysisConfig())}


@pytest.mark.parametrize("name,passes,exact", [("tuned-exact", 2, True),
                                               ("default", 1, False)])
def test_key_stft_passes_chunks_and_hpcp_spans(recordings, name, passes, exact):
    recs = recordings[name]
    byid = {r["id"]: r for r in recs}
    counted = [r for r in recs if r["counts"].get("key_stft_passes")]
    assert sum(r["counts"]["key_stft_passes"] for r in counted) == passes
    stages = ["key.tuning", "key.stft"][2 - passes:]
    assert [r["name"] for r in counted] == stages
    assert all(byid[r["parent"]]["name"] == "key" for r in counted)
    chunks = [r["counts"]["key_stft_chunks"] for r in counted]
    assert chunks[0] >= 1 and len(set(chunks)) == 1  # both passes stream alike
    hpcp = [r for r in recs if r["name"] == "key.hpcp"]
    assert len(hpcp) == chunks[-1]
    assert all(r["attrs"] == {"exact": exact} for r in hpcp)
    assert all(byid[r["parent"]]["name"] == "key.stft" for r in hpcp)


def _ctx(summary=None, durations=(180.0,) * 40, cfg=TUNED):
    run = SimpleNamespace(port_cfg=cfg, sample_rate=SR)
    window = {"attempted": len(durations),
              "outputs": [{"duration_seconds": np.asarray(durations)}]}
    return SimpleNamespace(run=run, summary=summary, window=window)


@pytest.mark.parametrize("name,passes", [("tuned-exact", 2.0), ("default", 1.0)])
def test_readers_on_a_recorded_cpu_call(recordings, monkeypatch, name, passes):
    """The pass counter reads on the CPU; the stream times and the kernel's
    device time do not exist there."""
    recs = recordings[name]
    monkeypatch.setattr(tracing, "spans", lambda: [dict(r) for r in recs])
    assert harness.load_reader("key_stft_passes_per_call")(_ctx()) == passes
    for reader in ("key_tuning_ms_per_track", "key_hpcp_ms_per_track.exact",
                   "polyphase_stage2.tuned-exact_roofline"):
        assert harness.load_reader(reader)(_ctx()) is None, reader


def test_roofline_reader_counts_every_pass(recordings, monkeypatch):
    """Over the same device time the two-pass reader reads the accepted
    one-pass reader's share times the passes a call made."""
    summary = {"device_s_by_name": {"polyphase_stage2_kernel": 0.25}}
    one = harness.load_reader("polyphase_stage2_roofline")(_ctx(summary))
    assert one > 0
    for name, passes in (("tuned-exact", 2), ("default", 1)):
        recs = recordings[name]
        monkeypatch.setattr(tracing, "spans", lambda recs=recs: [dict(r) for r in recs])
        got = harness.load_reader("polyphase_stage2.tuned-exact_roofline")(_ctx(summary))
        assert got == pytest.approx(passes * one, rel=1e-12)


def test_stream_readers_on_hand_made_spans(monkeypatch):
    def rec(i, name, parent, stream_ms=None, call=1, counts=None, **attrs):
        return {"id": i, "name": name, "parent": parent, "call": call, "thread": 1,
                "start_ns": i, "end_ns": i + 1, "host_ms": 1.0, "stream_ms": stream_ms,
                "counts": counts or {}, "attrs": attrs}

    recs = [rec(1, "analyze", None, 1000.0, tracks=40),
            rec(2, "key", 1, 600.0),
            rec(3, "key.tuning", 2, 250.0, counts={"key_stft_passes": 1}),
            rec(4, "key.stft", 2, 300.0, counts={"key_stft_passes": 1}),
            rec(5, "key.hpcp", 4, 20.0, exact=True),
            rec(6, "key.hpcp", 4, 30.0, exact=True),
            rec(7, "key.hpcp", 4, 1000.0, exact=False)]
    monkeypatch.setattr(tracing, "spans", lambda: [dict(r) for r in recs])
    read = harness.load_reader
    assert read("key_tuning_ms_per_track")(_ctx()) == pytest.approx(250.0 / 40)
    assert read("key_hpcp_ms_per_track.exact")(_ctx()) == pytest.approx(50.0 / 40)
    assert read("key_stft_passes_per_call")(_ctx()) == 2.0
    # spans without the counter, the exact mark or stream times read nothing
    monkeypatch.setattr(tracing, "spans", lambda: [dict(r, counts={}, attrs={}, stream_ms=None)
                                                   for r in recs])
    for name in ("key_tuning_ms_per_track", "key_hpcp_ms_per_track.exact",
                 "key_stft_passes_per_call"):
        assert read(name)(_ctx()) is None, name


@pytest.mark.parametrize("name", ["key_tuning_ms_per_track", "key_hpcp_ms_per_track.exact",
                                  "key_stft_passes_per_call",
                                  "polyphase_stage2.tuned-exact_roofline"])
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
def test_every_sync_of_tuned_exact_lies_in_a_host_read_on_card():
    """Under the card's sync debug mode, each synchronizing call of a warm
    tuned-exact batch lies inside a ``host_read``; the batch equals the plain
    reference's on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync debug mode watches the card")
    dev = torch.device("cuda:0")
    x, n = _batch(n=4, seconds=30.0)
    x, n = x.to(dev), n.to(dev)
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

    port.analyze_batch(x, n, TUNED, SR, device=dev)
    torch.cuda.synchronize()
    with warnings.catch_warnings(), tracing.recording():
        warnings.simplefilter("always")
        warnings.showwarning = seen
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = port.analyze_batch(x, n, TUNED, SR, device=dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert inside > 0 and outside == [], sorted(set(map(str, outside)))
    ref = reference.analyze(x, n, CONFIG, SR)
    tally = compare.Tally()
    compare.add_batch(tally, {k: v.cpu().numpy() for k, v in out.items()}, ref)
    assert compare.judge(tally.numbers(), LIMITS)[0], tally.numbers()
