"""The port's tracer (``stratum_dsp_tpu_torch/tracing.py``) on the CPU: the
spans of a call and their nesting, the counters, the cost of the off path,
the profiler's clock, the batch CLI's decode thread, the reset. Imports no
JAX, so that its ``cuda`` test runs on the card with the conftest left out:
``python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_tracing.py``."""

import contextvars
import json
import threading
import warnings
import wave

import numpy as np
import pytest
import torch

import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch import testing, tracing
from stratum_dsp_tpu_torch.cli import analyze_batch as batch_cli

torch.set_num_threads(2)

# three of four escalate under the default config; under HPSS one track of
# the low trap (the CPU's masked medians take seconds a track)
BATCHES = {"default": ([120.0, 172.0, 70.0, 190.0], 8.0), "hpss": ([70.0], 6.0)}
HPSS = dict(enable_hpss_onsets=True, enable_tempogram_percussive_fallback=True,
            normalization="loudness")
STAGES = {
    "default": ["to_device", "preprocess", "onsets", "bpm_features", "consensus", "legacy",
                "tempogram", "escalate", "select", "grid", "key", "finish"],
    "hpss": ["to_device", "preprocess", "onsets", "bpm_features", "hpss", "consensus",
             "legacy", "tempogram", "escalate", "percussive_fallback", "select", "grid", "key",
             "finish"],
}
CONFIGS = {"default": port.AnalysisConfig(), "hpss": port.AnalysisConfig.from_dict(HPSS)}


def _batch(config="default"):
    tempi, seconds = BATCHES[config]
    x = testing.kick_patterns(tempi, seconds)
    return x, [x.shape[1]] * len(tempi)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def recorded(request):
    """One recorded CPU call of a config: its result, spans and counters."""
    x, lengths = _batch(request.param)
    port.reset_launch_counts()
    with tracing.recording():
        out = port.analyze_batch(x, lengths, CONFIGS[request.param], device="cpu")
    return request.param, out, tracing.spans(), tracing.counters()


def _children(recs, parent):
    return [r for r in recs if r["parent"] == parent["id"] and r["name"] != "host_read"]


def test_stages_tile_the_root_in_code_order(recorded):
    name, _, recs, _ = recorded
    roots = [r for r in recs if r["name"] == "analyze"]
    assert len(roots) == 1 and roots[0]["parent"] is None
    root = roots[0]
    assert root["attrs"] == {"tracks": len(BATCHES[name][0])}
    stages = _children(recs, root)
    assert [r["name"] for r in stages] == STAGES[name]
    for a, b in zip(stages, stages[1:]):
        assert a["end_ns"] <= b["start_ns"]
    assert {r["call"] for r in recs} == {root["call"]}
    byid = {r["id"]: r for r in recs}
    for r in recs:
        assert r["thread"] == root["thread"] and r["stream_ms"] is None
        if r is not root:
            up = byid[r["parent"]]
            assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] <= up["end_ns"], r["name"]
    named = {r["name"] for r in recs}
    assert {"escalate.gather", "multires.hop256", "multires.vote", "escalate.scatter",
            "key.stft", "key.chroma", "key.score"} <= named
    if name == "hpss":
        hpss = next(r for r in stages if r["name"] == "hpss")
        assert [r["name"] for r in _children(recs, hpss)] == ["hpss.spectrogram",
                                                              "hpss.decompose"]


def test_counters_match_the_outputs_and_the_spans(recorded):
    name, out, recs, counters = recorded
    escalated = int(out["multi_res_triggered"].sum())
    assert escalated == {"default": 3, "hpss": 1}[name]
    assert counters["escalated_rows"] == escalated
    reads = [r for r in recs if r["name"] == "host_read"]
    assert counters["host_reads"] == len(reads) > 0
    assert sum(r["counts"].get("host_reads", 0) for r in recs) == len(reads)
    gather = next(r for r in recs if r["name"] == "escalate.gather")
    assert gather["counts"]["escalated_rows"] == escalated
    assert {"silence.trim", "escalate.nonzero", "variation.any"} <= {
        r["attrs"]["site"] for r in reads}
    assert "h2d_bytes" not in counters  # nothing is copied to a card


def test_off_records_nothing_and_still_counts(monkeypatch):
    opened = []
    real = torch.autograd._record_function_with_args_enter
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        lambda name, *a: opened.append(name) or real(name, *a))
    x, lengths = _batch()
    port.reset_launch_counts()
    out = port.analyze_batch(x, lengths, CONFIGS["default"], device="cpu")
    assert tracing.spans() == [] and opened == []
    counters = tracing.counters()
    assert counters["escalated_rows"] == int(out["multi_res_triggered"].sum())
    assert counters["host_reads"] > 0
    with tracing.recording(), tracing.span("probe"):
        pass
    assert opened == ["stratum.probe"]


def test_spans_lie_on_the_profilers_clock(tmp_path):
    x, lengths = _batch()
    with tracing.recording(), tracing.span("warm"):  # the first entry's own cost
        pass
    port.reset_launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        port.analyze_batch(x[:1], lengths[:1], CONFIGS["default"], device="cpu",
                           debug_stop_after="legacy")
    recs = tracing.spans()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = sorted((e for e in trace["traceEvents"] if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"
                     and str(e.get("name", "")).startswith("stratum.")),
                    key=lambda e: float(e["ts"]))
    assert [e["name"] for e in events] == ["stratum." + r["name"] for r in recs]
    assert len(recs) > 5
    for r, e in zip(recs, events):
        start = base + float(e["ts"]) * 1e3
        end = start + float(e["dur"]) * 1e3
        assert abs(r["start_ns"] - start) <= 50e3 and abs(r["end_ns"] - end) <= 50e3, r["name"]


def test_batch_cli_records_its_decode_thread(tmp_path):
    x, _ = _batch()
    paths = []
    for i, row in enumerate((x[:2].clamp(-1, 1) * 32767).to(torch.int16).numpy()):
        paths.append(str(tmp_path / f"t{i}.wav"))
        with wave.open(paths[-1], "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(44100)
            w.writeframes(row.astype("<i2").tobytes())
    port.reset_launch_counts()
    with tracing.recording():
        rc = batch_cli.main([*paths, "-o", str(tmp_path / "out.jsonl"), "--device", "cpu",
                             "--batch-size", "1"])
    assert rc == 0
    recs = tracing.spans()
    (top,) = [r for r in recs if r["name"] == "cli.batch"]
    decodes = [r for r in recs if r["name"] == "cli.decode"]
    assert [r["attrs"] for r in decodes] == [{"files": 1}, {"files": 1}]
    assert all(r["parent"] == top["id"] and r["thread"] != top["thread"] for r in decodes)
    roots = [r for r in recs if r["name"] == "analyze"]
    assert len(roots) == 2 and all(r["parent"] == top["id"] for r in roots)
    assert len({r["call"] for r in roots}) == 2
    for name in ("cli.wait", "cli.assemble", "cli.results"):
        assert any(r["name"] == name and r["parent"] == top["id"] for r in recs), name


def test_mesh_shards_share_their_calls_id():
    from stratum_dsp_tpu_torch.parallel.mesh import make_mesh

    x, lengths = _batch()
    port.reset_launch_counts()
    with tracing.recording():
        port.analyze_batch_arrays(x, torch.as_tensor(lengths), CONFIGS["default"], 44100,
                                  mesh=make_mesh([torch.device("cpu")] * 2))
    recs = tracing.spans()
    (top,) = [r for r in recs if r["name"] == "mesh"]
    roots = [r for r in recs if r["name"] == "analyze"]
    assert [r["attrs"] for r in roots] == [{"tracks": 2}, {"tracks": 2}]
    assert all(r["parent"] == top["id"] for r in roots)
    assert {r["call"] for r in recs} == {top["call"]}


def test_reset_clears_counters_and_spans():
    with tracing.recording(), tracing.span("probe"):
        tracing.count("escalated_rows", 2)
    assert tracing.spans() and tracing.counters()
    port.reset_launch_counts()
    assert tracing.spans() == [] and tracing.counters() == {}


def test_worker_threads_take_the_open_span():
    """A thread run in a copy of the caller's context records under the
    caller's span; one started without it does not record."""
    def open_one(name):
        with tracing.span(name):
            pass

    port.reset_launch_counts()
    with tracing.recording(), tracing.span("outer", call=True) as outer:
        inner = threading.Thread(target=contextvars.copy_context().run,
                                 args=(open_one, "inner"))
        bare = threading.Thread(target=open_one, args=("bare",))
        for th in (inner, bare):
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
    recs = {r["name"]: r for r in tracing.spans()}
    assert set(recs) == {"outer", "inner"}
    assert recs["inner"]["parent"] == outer.id and recs["inner"]["call"] == outer.call


@pytest.mark.cuda
def test_every_sync_lies_in_a_host_read_on_card():
    """Under the card's sync debug mode, each synchronizing call of a warm
    batch of the default and the HPSS config lies inside a ``host_read``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync debug mode watches the card")
    dev = torch.device("cuda:0")
    outside, inside = [], 0

    def seen(message, category, filename, lineno, file=None, line=None):
        nonlocal inside
        if "synchronizing CUDA operation" not in str(message):
            return  # the mode's own notice that it is a prototype
        open_span = tracing._OPEN.get()
        if open_span is not None and open_span.name == "host_read":
            inside += 1
        else:
            outside.append(open_span.name if open_span else None)

    for name, cfg in CONFIGS.items():
        x, lengths = _batch(name)
        port.analyze_batch(x.numpy(), np.asarray(lengths), cfg, device=dev)
        torch.cuda.synchronize()
        with warnings.catch_warnings(), tracing.recording():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = port.analyze_batch(x.numpy(), np.asarray(lengths), cfg, device=dev)
                port.decode_results(out, 44100)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    assert inside > 0 and outside == []
