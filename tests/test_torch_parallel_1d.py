"""The port's 1-D tracks mesh on the CPU: eight shards of two tracks against
the JAX package's unsharded pipeline on the same sixteen tracks (the
trap-zone and clean seeds of ``tests/test_timeblocks.py``, so that shards
escalate none, one or both of their tracks), and the chunk sizes a shard
takes from the whole batch.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from stratum_dsp_tpu.analysis import PipelineCaps as JaxCaps
from stratum_dsp_tpu.analysis import analyze_batch as jax_analyze
from stratum_dsp_tpu.config import AnalysisConfig as JaxConfig
from stratum_dsp_tpu.features.key import pipeline as jkey
from stratum_dsp_tpu.testing import kick_pattern, pad_batch

import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch.analysis import pipeline as ppipe
from stratum_dsp_tpu_torch.features.key import pipeline as pkey
from stratum_dsp_tpu_torch.parallel import mesh as pmesh
from stratum_dsp_tpu_torch.testing import assert_outputs_match

SR = 44100
CPU = torch.device("cpu")
CAPS = dict(max_onsets=256, max_beats=256, seg_beat_cap=16, max_segments=6)
# tests/test_timeblocks.py:96-97: trap-zone (75/172/78) and clean seeds interleaved
BPMS = (75.0, 120.0, 128.0, 172.0, 78.0, 174.0, 101.0, 132.0,
        140.0, 76.0, 96.0, 108.0, 176.0, 116.0, 88.0, 124.0)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_1d_mesh_over_8_shards_matches_jax():
    """Every output of the default config, discrete ones exactly, the
    escalation flags included: each shard gathers its own escalated rows."""
    samples, lengths = pad_batch([kick_pattern(x, 6.0) for x in BPMS])
    cfg = JaxConfig()
    with pytest.MonkeyPatch.context() as mp:
        # the JAX side takes the TPU's key STFT, as the port does
        mp.setenv("STRATUM_FORCE_POLYPHASE", "1")
        mp.setenv("STRATUM_FORCE_PALLAS_POLY2", "1")
        jax.clear_caches()  # traces are cached by static args, not by env
        try:
            want = {k: np.asarray(v) for k, v in
                    jax_analyze(samples, lengths, cfg, SR, JaxCaps(**CAPS)).items()}
        finally:
            jax.clear_caches()
    got = pmesh.analyze_batch_sharded(samples, lengths,
                                      port.AnalysisConfig.from_dict(dataclasses.asdict(cfg)), SR,
                                      port.PipelineCaps(**CAPS), pmesh.make_mesh([CPU] * 8))
    trig = want["multi_res_triggered"].reshape(8, 2).sum(axis=1)
    assert {0, 1, 2} <= set(trig.tolist()), trig  # shards escalate 0, 1 and 2 tracks
    assert_outputs_match(want, got)


def test_1d_shards_size_their_chunks_for_the_whole_batch(monkeypatch):
    """Eight shards of two rows: the key STFT's chunk is the one the whole
    batch of 16 gets (457 frames, where two rows alone would get 512), and
    the BPM chunk is capped for 16 rows; the outputs are the unsharded
    run's, under tuning compensation (per-chunk partial sums)."""
    assert pkey._auto_chunk(16, 8192, 512) == jkey._auto_chunk(16, 8192, 512) == 457
    assert pkey._auto_chunk(2, 8192, 512) == 512
    seen_key, seen_bpm = [], []
    real_key, real_bpm = pkey.stft_reduce, ppipe.nov.compute_bpm_spectral_features

    def key_spy(samples, *args, **kw):
        seen_key.append((samples.shape[0], kw["chunk_frames"]))
        return real_key(samples, *args, **kw)

    def bpm_spy(samples, *args, **kw):
        seen_bpm.append((samples.shape[0], kw["chunk_batch"]))
        return real_bpm(samples, *args, **kw)

    monkeypatch.setattr(pkey, "stft_reduce", key_spy)
    monkeypatch.setattr(ppipe.nov, "compute_bpm_spectral_features", bpm_spy)
    x = port.testing.kick_patterns(np.linspace(90.0, 150.0, 16), 2.0)
    n = torch.full((16,), x.shape[1])
    cfg = port.SLICE_CONFIG.replace(enable_key_tuning_compensation=True)
    caps = port.PipelineCaps(max_onsets=128, max_beats=64, seg_beat_cap=16, max_segments=4)
    got = pmesh.analyze_batch_sharded(x, n, cfg, SR, caps, pmesh.make_mesh([CPU] * 8))
    assert seen_key == [(2, 457)] * 16  # eight shards, two key passes each
    assert seen_bpm == [(2, 16)] * 8
    seen_key.clear()
    want = port.analyze_batch(x, n, cfg, SR, caps, device="cpu")
    assert seen_key == [(16, 457)] * 2
    assert_outputs_match(want, got)
