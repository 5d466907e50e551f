"""The generator: the same seed gives the same tracks, every seed the same
strata, zones and lengths."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import synth, traffic

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
BIG_SEED = 2**31 + 987654321


def mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("n,core,low,high", [(40, 28, 6, 6), (16, 11, 2, 3)])
def test_adversarial_proportions(n, core, low, high):
    specs = traffic.draw_specs(mix("adversarial"), n, np.random.default_rng(BIG_SEED))
    zones = [s["zone"] for s in specs]
    assert (zones.count("core"), zones.count("low"), zones.count("high")) == (core, low, high)
    m = mix("adversarial")
    for s in specs:
        lo, hi = {"core": m["core_bpm"], "low": m["trap_low_bpm"], "high": m["trap_high_bpm"]}[
            s["zone"]]
        assert lo <= s["bpm"] <= hi and s["bpm"] == int(s["bpm"])
        assert m["tonal_offset_s"][0] <= s["offset_s"] < m["tonal_offset_s"][1]
        assert s["seconds"] == m["track_seconds"]


def test_every_key_in_each_run_of_24():
    specs = traffic.draw_specs(mix("adversarial"), 40, np.random.default_rng(3))
    assert sorted(s["key"] for s in specs[:24]) == list(range(24))


def test_seeds_share_tempi_and_lengths():
    """Two seeds differ in keys and offsets, not in the work: the same tempo
    and length at each place."""
    for name, n in (("adversarial", 40), ("single", 0)):
        a = traffic.draw_specs(mix(name), n, np.random.default_rng(1))
        b = traffic.draw_specs(mix(name), n, np.random.default_rng(2))
        assert [(s["bpm"], s["seconds"]) for s in a] == [(s["bpm"], s["seconds"]) for s in b]
        assert [s["key"] for s in a] != [s["key"] for s in b]


def test_tempi_are_bench_pys():
    bpms, _ = traffic.tempi(40, mix("adversarial"))
    want = np.concatenate([np.round(np.linspace(85.0, 168.0, 28)),
                           np.round(np.linspace(56.0, 79.0, 6)),
                           np.round(np.linspace(172.0, 199.0, 6))])
    np.testing.assert_array_equal(bpms, want)


def test_single_lengths():
    specs = traffic.draw_specs(mix("single"), 0, np.random.default_rng(BIG_SEED))
    m = mix("single")
    assert sorted(s["seconds"] for s in specs) == sorted(m["lengths_s"] * m["tracks_per_length"])


@pytest.mark.parametrize("name", ["adversarial", "single", "files"])
def test_same_seed_same_specs(name):
    a = traffic.draw_specs(mix(name), 40, np.random.default_rng(BIG_SEED))
    b = traffic.draw_specs(mix(name), 40, np.random.default_rng(BIG_SEED))
    c = traffic.draw_specs(mix(name), 40, np.random.default_rng(BIG_SEED + 1))
    assert a == b and a != c


def test_same_specs_same_samples():
    specs = [{"bpm": 128.0, "key": 21, "offset_s": 1.25, "seconds": 3.0, "zone": "core"},
             {"bpm": 60.0, "key": 4, "offset_s": 0.0, "seconds": 2.0, "zone": "low"}]
    a = synth.tracks(specs, 3 * synth.SAMPLE_RATE, "cpu")
    b = synth.tracks(specs, 3 * synth.SAMPLE_RATE, "cpu")
    assert torch.equal(a, b)
    assert a.shape == (2, 3 * synth.SAMPLE_RATE) and a.dtype == torch.float32
    assert torch.all(a[1, 2 * synth.SAMPLE_RATE:] == 0)
    assert float(a.abs().max()) == pytest.approx(1.0, abs=1e-6)


def test_chord_layer_starts_at_its_offset_and_holds_the_key():
    x = synth.chord_layer(9, False, 120.0, 0.5, 4 * synth.SAMPLE_RATE, "cpu")
    assert torch.all(x[:int(0.5 * synth.SAMPLE_RATE)] == 0)
    spec = np.abs(np.fft.rfft(x[int(0.6 * synth.SAMPLE_RATE):int(1.9 * synth.SAMPLE_RATE)].numpy()))
    freqs = np.fft.rfftfreq(int(1.9 * synth.SAMPLE_RATE) - int(0.6 * synth.SAMPLE_RATE),
                            1 / synth.SAMPLE_RATE)
    peak = freqs[np.argmax(spec)]
    # the first chord of A minor is A minor: its root A3 = 220 Hz sounds loudest
    assert abs(peak - 220.0) < 2.0
