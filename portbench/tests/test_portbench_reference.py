"""The plain reference agrees with the port on the CPU at a tiny size, and
the control's arithmetic moves it."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import compare, reference, synth, traffic

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def tiny_batch(seed=5, n=3, seconds=8.0):
    m = json.loads((TRAFFIC / "adversarial.json").read_text())
    specs = traffic.draw_specs(dict(m, track_seconds=seconds), n, np.random.default_rng(seed))
    t = int(seconds * synth.SAMPLE_RATE)
    return synth.tracks(specs, t, "cpu"), torch.full((n,), t, dtype=torch.int64)


@pytest.mark.parametrize("config", ["default", "hpss"])
def test_reference_equals_the_port_on_the_cpu(config):
    import stratum_dsp_tpu_torch as port

    cfg = json.loads((CONFIGS / f"{config}.json").read_text())
    x, n = tiny_batch(seconds=8.0 if config == "default" else 5.0)
    ref = reference.analyze(x, n, cfg, synth.SAMPLE_RATE)
    got = port.analyze_batch(x, n, port.AnalysisConfig.from_dict(cfg["analysis_config"]),
                             synth.SAMPLE_RATE, port.PipelineCaps(**cfg["pipeline_caps"]),
                             device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)


def test_control_moves_the_scores():
    cfg = json.loads((CONFIGS / "default.json").read_text())
    x, n = tiny_batch()
    ref = reference.analyze(x, n, cfg, synth.SAMPLE_RATE)
    with reference.lower_precision():
        low = reference.analyze(x, n, cfg, synth.SAMPLE_RATE)
    tally = compare.Tally()
    compare.add_batch(tally, low, ref)
    assert tally.numbers()["score_gap_p50"] > 1e-4


def test_file_records_read_what_was_written(tmp_path):
    from portbench import drivers

    x, n = tiny_batch(n=2, seconds=3.0)
    paths = drivers.write_wavs(x, n.numpy(), tmp_path)
    back = reference.read_wav(paths[0])
    expect = (x[0].clamp(-1, 1) * 32767.0).to(torch.int16).numpy().astype(np.float32) / 32768.0
    np.testing.assert_array_equal(back, expect)
    assert reference.bucket_samples(len(back), synth.SAMPLE_RATE) == 60 * synth.SAMPLE_RATE
