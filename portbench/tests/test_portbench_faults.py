"""The harness, its look for a card skipped, driven on the CPU at a size the
CPU holds, with the port's timed path broken underneath: ``correct`` comes
out false for each fault a cell can have, and true with nothing broken."""

import time
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
TINY = {
    "default.adversarial": {"config": {"batch_size": 4}, "mix": {"track_seconds": 5.0}},
    "default.single": {"mix": {"lengths_s": [4.0, 6.0], "tracks_per_length": 1}},
    "default.files": {"config": {"batch_size": 2}, "mix": {"track_seconds": 4.0, "copies": 2}},
}


def run_tiny(cell):
    res, _ = harness.run_cell(ROOT, cell, 2**31 + 17, 0.1, False, "cpu", time.perf_counter(),
                              log=lambda m: None, overrides=TINY[cell])
    return res


def alter_answers(out):
    """Every track's BPM a beat a minute off, where the pipeline makes it."""
    return dict(out, bpm=out["bpm"] + 1.0)


def drop_half(out):
    """The second half of the batch left out: its rows hold the first half's."""
    b = out["ok"].shape[0]
    keep = torch.arange(b) % max(b // 2, 1)
    return {k: v[keep.to(v.device)] for k, v in out.items()}


def break_pipeline(monkeypatch, fault):
    from stratum_dsp_tpu_torch.analysis import pipeline

    real = pipeline._analyze
    monkeypatch.setattr(pipeline, "_analyze", lambda *a, **k: fault(real(*a, **k)))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell):
    assert run_tiny(cell)["correct"] is True


@pytest.mark.parametrize("cell,fault", [
    ("default.adversarial", alter_answers), ("default.adversarial", drop_half),
    ("default.single", alter_answers), ("default.files", alter_answers),
    ("default.files", drop_half)])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    break_pipeline(monkeypatch, fault)
    assert run_tiny(cell)["correct"] is False
