"""The readers of the port's own spans on a hand-made span list and counter
table: each gives its number from the spans' counts alone, and None where
its spans are absent or the port has no tracer."""

import sys
from types import SimpleNamespace

import pytest

import stratum_dsp_tpu_torch
from portbench import harness
from stratum_dsp_tpu_torch import tracing


def rec(id_, name, parent=None, call=1, host_ms=1.0, stream_ms=None, counts=None, **attrs):
    return {"id": id_, "name": name, "parent": parent, "call": call, "thread": 1,
            "start_ns": id_, "end_ns": id_ + 1, "host_ms": host_ms, "stream_ms": stream_ms,
            "counts": counts or {}, "attrs": attrs}


# two calls of 40 tracks each (call 1, call 2), a host_read outside them (call
# None, as the batch CLI's results read), and the batch CLI's own spans
BATCH = [
    rec(1, "analyze", host_ms=900.0, stream_ms=800.0, tracks=40),
    rec(2, "preprocess", 1, stream_ms=10.0, counts={"host_reads": 2}),
    rec(3, "onsets", 1, stream_ms=4.0),
    rec(4, "bpm_features", 1, stream_ms=100.0, counts={"host_reads": 1}),
    rec(5, "consensus", 1, stream_ms=6.0),
    rec(6, "legacy", 1, stream_ms=20.0),
    rec(7, "tempogram", 1, stream_ms=30.0, counts={"host_reads": 20}),
    rec(8, "escalate", 1, stream_ms=120.0),
    rec(9, "escalate.gather", 8, counts={"host_reads": 1, "escalated_rows": 12}),
    rec(10, "select", 1, stream_ms=2.0),
    rec(11, "grid", 1, stream_ms=50.0, counts={"host_reads": 7}),
    rec(12, "key", 1, stream_ms=400.0, counts={"host_reads": 4}),
    rec(13, "host_read", 2, host_ms=3.0, site="silence.trim"),
    rec(14, "host_read", 9, host_ms=5.0, site="escalate.nonzero"),
    rec(21, "analyze", call=2, host_ms=1000.0, stream_ms=880.0, tracks=40),
    rec(22, "preprocess", 21, call=2, stream_ms=14.0, counts={"host_reads": 2}),
    rec(23, "onsets", 21, call=2, stream_ms=4.0),
    rec(24, "bpm_features", 21, call=2, stream_ms=100.0, counts={"h2d_bytes": 1_693_440_160}),
    rec(25, "consensus", 21, call=2, stream_ms=6.0),
    rec(26, "legacy", 21, call=2, stream_ms=20.0),
    rec(27, "tempogram", 21, call=2, stream_ms=30.0),
    rec(28, "escalate", 21, call=2, stream_ms=120.0),
    rec(29, "escalate.gather", 28, call=2, counts={"escalated_rows": 12}),
    rec(30, "select", 21, call=2, stream_ms=2.0),
    rec(31, "grid", 21, call=2, stream_ms=50.0),
    rec(32, "key", 21, call=2, stream_ms=400.0),
    rec(33, "host_read", 22, call=2, host_ms=7.0, site="silence.trim"),
    rec(40, "cli.batch", call=None, host_ms=5000.0, files=80),
    rec(41, "cli.decode", 40, call=None, host_ms=1200.0, files=40),
    rec(42, "cli.decode", 40, call=None, host_ms=1000.0, files=40),
    rec(43, "cli.wait", 40, call=None, host_ms=1100.0),
    rec(44, "cli.wait", 40, call=None, host_ms=1.0),
    rec(45, "host_read", 40, call=None, host_ms=50.0, site="results",
        counts={"host_reads": 1}),
    rec(50, "hpss.decompose", 1, stream_ms=5600.0),
]
# the process-wide table, which the readers never take
COUNTERS = {"host_reads": 999, "escalated_rows": 999, "h2d_bytes": 999}

EXPECTED = {
    "preprocess_ms_per_track": (10.0 + 14.0) / 80,
    "onsets_ms_per_track": (4.0 + 6.0) * 2 / 80,
    "bpm_features_ms_per_track": 200.0 / 80,
    "bpm_estimate_ms_per_track": (20.0 + 30.0 + 2.0) * 2 / 80,
    "escalation_ms_per_escalated_track": 240.0 / 24,
    "grid_ms_per_track": 100.0 / 80,
    "key_ms_per_track": 800.0 / 80,
    "host_reads_per_batch": (2 + 1 + 20 + 1 + 7 + 4 + 2) / 2,
    "hpss_ms_per_track": 5600.0 / 80,
    "dispatch_ms_per_track.single": (1900.0 - 15.0) / 80,
    "host_read_wait_ms_per_track.single": 15.0 / 80,
    "cli_decode_ms_per_track": 2200.0 / 80,
    "cli_decode_wait_ms_per_track": 1101.0 / 80,
    "h2d_mb_per_track": 1693.44016 / 80,
}
CTX = SimpleNamespace(summary=None, window={"attempted": 80})


@pytest.fixture
def spans_are(monkeypatch):
    def feed(recs):
        monkeypatch.setattr(tracing, "spans", lambda: [dict(r) for r in recs])
        monkeypatch.setattr(tracing, "counters", lambda: dict(COUNTERS))
    return feed


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_hand_made_spans(name, spans_are):
    spans_are(BATCH)
    assert harness.load_reader(name)(CTX) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_none_without_its_spans(name, spans_are):
    spans_are([])
    assert harness.load_reader(name)(CTX) is None
    # the spans of another reader's layer only
    other = [r for r in BATCH if r["name"] == "cli.batch"]
    spans_are(other)
    assert harness.load_reader(name)(CTX) is None


STREAM_READERS = ("preprocess_ms_per_track", "onsets_ms_per_track",
                  "bpm_features_ms_per_track", "bpm_estimate_ms_per_track",
                  "escalation_ms_per_escalated_track", "grid_ms_per_track", "key_ms_per_track",
                  "hpss_ms_per_track")


def test_stream_readers_read_none_off_a_card(spans_are):
    spans_are([dict(r, stream_ms=None) for r in BATCH])
    for name in STREAM_READERS:
        assert harness.load_reader(name)(CTX) is None, name


def test_escalation_reads_none_where_nothing_escalated(spans_are):
    spans_are([dict(r, counts={}) for r in BATCH])
    assert harness.load_reader("escalation_ms_per_escalated_track")(CTX) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_none_without_the_tracer(name, monkeypatch):
    """A parent checkout's port has no ``tracing`` module."""
    monkeypatch.delattr(stratum_dsp_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "stratum_dsp_tpu_torch.tracing", None)
    assert harness.load_reader(name)(CTX) is None
