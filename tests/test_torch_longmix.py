"""The ``longmix`` configuration of the benchmark (``portbench/configs/
longmix.json``: the upstream's defaults on whole two-hour DJ mixes) on the
CPU: its capacities against the formulas that make them cover 7200 s at
300 BPM, checked through the functions that apply them; the port against the
benchmark's plain reference on tracks of the cell's mix under capacities
from those formulas and under capacities too small, with the rows a capacity
cut counted (``capped_rows``); the readers of the cell's per-layer metrics.
Imports no JAX. Kernels B and C past shared memory, which this configuration
reaches, are held to their plain versions on the card by
``tests/test_torch_viterbi.py`` and ``tests/test_torch_downbeats.py``."""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import stratum_dsp_tpu_torch as port
from portbench import compare, harness, reference, synth, traffic
from stratum_dsp_tpu_torch import measure, tracing
from portbench.reference.plain.features.onset import peaks as plain_peaks
from stratum_dsp_tpu_torch.features.beat import hmm, variation
from stratum_dsp_tpu_torch.features.onset import peaks

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
CELL = "longmix.adversarial-2h"
CONFIG = json.loads((BENCH / "configs" / "longmix.json").read_text())
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())["limits"]
SR = 44100
MIX_SECONDS = 7200.0  # a whole two-hour mix
MAX_BPM = 300.0  # the fastest tempo hmm.track_beats accepts
SEGMENT_HOP_S = 4.0  # variation.refine_beats: segments of 8 s on a 4 s hop past 32 s


def caps_for(seconds: float) -> dict:
    """The capacities of ``longmix.json``'s formulas for tracks of
    ``seconds``: a beat slot an interval at 300 BPM from the first onset to
    the last, plus one; a segment a hop; the onset capacity scaled from the
    configuration's to the length, up to a power of two."""
    onsets = CONFIG["pipeline_caps"]["max_onsets"] * seconds / MIX_SECONDS
    return {"max_beats": math.ceil(seconds * MAX_BPM / 60.0) + 1,
            "max_segments": math.ceil(seconds / SEGMENT_HOP_S),
            "max_onsets": 1 << math.ceil(math.log2(onsets))}


def _batch(n=2, seconds=60.0, seed=2**31 + 21):
    """``n`` tracks of the cell's mix (``portbench/traffic/adversarial-2h.json``)
    at ``seconds`` each, on the CPU."""
    mix = json.loads((BENCH / "traffic" / "adversarial-2h.json").read_text())
    specs = traffic.draw_specs(dict(mix, track_seconds=seconds), n, np.random.default_rng(seed))
    t = int(seconds * synth.SAMPLE_RATE)
    return synth.tracks(specs, t, "cpu"), torch.full((n,), t, dtype=torch.int64)


def test_config_covers_two_hours_at_300_bpm():
    caps = CONFIG["pipeline_caps"]
    assert caps["max_beats"] >= caps_for(MIX_SECONDS)["max_beats"] == 36001
    assert caps["max_segments"] >= caps_for(MIX_SECONDS)["max_segments"] == 1800
    assert caps["max_onsets"] >= caps_for(MIX_SECONDS)["max_onsets"]
    assert "seg_beat_cap" not in caps and "chunk_frames" not in caps
    full = port.PipelineCaps(**caps)
    walk = max(full.max_segments * full.seg_beat_cap, full.max_beats)
    assert (full.max_beats, walk) == (measure.LONG_FRAMES, measure.LONG_SLOTS)
    assert CONFIG["analysis_config"] == {} and CONFIG["reduced"] == []
    assert CONFIG["batch_size"] == 8 and CONFIG["sample_rate"] == SR
    mix = json.loads((BENCH / "traffic" / "adversarial-2h.json").read_text())
    assert mix["track_seconds"] == MIX_SECONDS
    # the port's own defaults stay those of a three-minute track
    assert port.PipelineCaps() == port.PipelineCaps(2048, 1024, 64, 48, 256)


@pytest.mark.parametrize("spare", [0, 1])
def test_caps_hold_a_two_hour_row_at_300_bpm(spare):
    """Through the functions that apply them: onsets at 300 BPM from 0 s to
    7199.9 s, the most a two-hour track can hold, need every beat slot and
    every segment of the configuration, and one fewer of either cuts the row
    (``tracing.flag_capped``)."""
    caps = CONFIG["pipeline_caps"]
    beat = float(np.float32(60.0) / np.float32(MAX_BPM))
    grid = torch.arange(int(MIX_SECONDS / beat), dtype=torch.float32) * beat
    onsets = torch.cat([grid, torch.tensor([MIX_SECONDS - 0.1])])[None]
    valid = torch.ones_like(onsets, dtype=torch.bool)
    bpm = torch.tensor([MAX_BPM])
    port.reset_launch_counts()
    with tracing.recording(), tracing.span("probe"), tracing.capped_rows() as capped:
        beats, _ = hmm.track_beats(bpm, onsets, valid, caps["max_beats"] - spare)
        assert bool(capped.mask[0]) == bool(spare)
    assert tracing.spans()[0]["counts"]["viterbi_frames"] == caps["max_beats"] - spare
    port.reset_launch_counts()
    with tracing.recording(), tracing.span("probe"), tracing.capped_rows() as capped:
        _, has_variation = variation.refine_beats(beats, bpm, torch.ones(1), onsets, valid, 64,
                                                  caps["max_segments"] - spare)
        assert bool(capped.mask[0]) == bool(spare) and not bool(has_variation[0])
    assert tracing.spans()[0]["counts"]["variation_segments"] == caps["max_segments"] - spare


@pytest.mark.parametrize("case", ["random", "near_start", "empty", "two_hour_row"])
def test_onset_dedup_equals_the_plain_walk(case):
    """The energy-flux onset dedup (pointer doubling, a fixed number of
    launches) keeps what the plain reference's slot-by-slot walk keeps: on
    sorted lists with valid entries first, at any minimum distance (zero and
    below included), near the walk's start value, on empty rows and lists, and
    on rows as long as a two-hour mix's onsets at the energy flux's spacing."""
    g = torch.Generator().manual_seed(21)
    trials = []
    for _ in range({"random": 200, "near_start": 100, "empty": 1, "two_hour_row": 1}[case]):
        b, k = int(torch.randint(1, 5, (1,), generator=g)), int(torch.randint(1, 70, (1,), generator=g))
        pos = torch.randint(0, 200, (b, k), generator=g)
        if case == "near_start":
            pos = pos - 2**30
        trials.append((pos, torch.randint(0, k + 1, (b,), generator=g),
                       int(torch.randint(-2, 12, (1,), generator=g))))
    if case == "empty":
        trials = [(torch.zeros(3, 0, dtype=torch.int64), torch.zeros(3, dtype=torch.int64), 256),
                  (torch.arange(6).repeat(3, 1), torch.tensor([0, 6, 0]), 2)]
    if case == "two_hour_row":  # ~38k onsets a row, 256 samples apart at the least
        pos = torch.cumsum(torch.randint(256, 1024, (4, 40000), generator=g), dim=-1)
        trials = [(pos, torch.tensor([38306, 0, 40000, 13787]), 128)]
    for pos, n, d in trials:
        valid = torch.arange(pos.shape[-1])[None] < n[:, None]
        pos = torch.where(valid, torch.sort(pos, dim=-1).values, 0)
        got = peaks.dedup_min_distance(pos, valid, d)
        assert got.dtype == torch.bool
        assert torch.equal(got, plain_peaks.dedup_min_distance(pos, valid, d)), (pos, n, d)


@pytest.mark.parametrize("case", ["formulas", "too_small"])
def test_port_equals_the_plain_reference_and_counts_capped_rows(case):
    """Two 60 s tracks of the cell's mix: every discrete output exactly and
    every float (BPM and beat times apart, which the comparison holds to
    their own gaps) within the cell's limit of ``score_gap_p50``, under the
    formulas' capacities for 60 s (no row cut) and under 4 segments and 64
    beat slots (both rows cut, and the reference cuts them alike)."""
    caps = caps_for(60.0)
    if case == "too_small":
        caps.update(max_segments=4, max_beats=64)
    x, n = _batch()
    port.reset_launch_counts()
    with tracing.recording():
        got = {k: v.numpy() for k, v in port.analyze_batch(
            x, n, port.AnalysisConfig(), SR, port.PipelineCaps(**caps), device="cpu").items()}
    recs = tracing.spans()
    counts = {k: sum(r["counts"].get(k, 0) for r in recs)
              for k in ("capped_rows", "variation_segments", "viterbi_frames", "downbeat_slots")}
    assert counts["capped_rows"] == {"formulas": 0, "too_small": 2}[case]
    assert counts["viterbi_frames"] <= 2 * caps["max_beats"]
    if case == "too_small":
        assert counts["variation_segments"] == 2 * 4
    else:  # a segment a 4 s hop from the first beat to the last, under 60 s
        assert 2 * 13 <= counts["variation_segments"] <= 2 * caps["max_segments"]
    assert counts["downbeat_slots"] == int(got["beat_valid"].sum())
    ref = reference.analyze(x, n, dict(CONFIG, pipeline_caps=caps), SR)
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
    assert tally.widest()["beat_gap_s"] == 0.0


def test_readers_of_the_cell():
    """The cell's per-layer readers on one recorded CPU call, and with a
    device summary that names the long paths' kernels; each reads None with
    nothing recorded (a port without the spans and counters)."""
    caps = caps_for(30.0)
    x, n = _batch(seconds=30.0)
    ctx = SimpleNamespace(
        summary={"device_s_by_name": {"void (anonymous namespace)::viterbi_long_kernel(...)": 1e-4,
                                      "void (anonymous namespace)::downbeat_long_kernel(...)": 1e-4}},
        run=SimpleNamespace(port_caps=port.PipelineCaps(**caps)))
    names = [m["name"] for m in harness.load_manifest(ROOT)["per_layer"]
             if CELL in m.get("workloads", [])]
    assert len(names) == 6
    port.reset_launch_counts()
    assert all(harness.load_reader(m)(ctx) is None for m in names)
    with tracing.recording():
        out = port.analyze_batch(x, n, port.AnalysisConfig(), SR, port.PipelineCaps(**caps),
                                 device="cpu")
    values = {m: harness.load_reader(m)(ctx) for m in names}
    # stream times exist only on a card
    assert values["beat_track_ms_per_track"] is None and values["variation_ms_per_track"] is None
    assert values["capped_rows_per_batch"] == 0.0
    assert 6 <= values["variation_segments_per_track"] <= caps["max_segments"]
    beats = int(out["beat_valid"].sum())
    slots = max(caps["max_segments"] * 64, caps["max_beats"])
    least = max((4 * beats + 8 * 2 + 2 * slots) / 3.35e12, 6 * beats / 67e12)
    assert values["downbeat_mask.longmix_roofline"] == pytest.approx(100.0 * least / 1e-4)
    assert 0.0 < values["viterbi_decode.longmix_roofline"] < 100.0
