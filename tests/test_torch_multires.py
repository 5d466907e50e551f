"""The port's multi-resolution escalation
(``stratum_dsp_tpu_torch/features/period/multi_resolution.py`` and the
escalation block of ``analysis/pipeline.py``) against the JAX package, and
the whole default ``AnalysisConfig`` through ``analyze_batch``.

* ``beat_contrast_score`` and ``multi_resolution_estimate`` on the four
  drum tracks of ``tests/test_multires_parity.py``. The estimate runs its
  three-STFT recompute branch on both sides; BPM is held to 1e-2, the
  confidence to 1e-3 and the hop agreement exactly. The contrast scores,
  on the same JAX novelty, differ by f32 summation order only (1e-4).
* ``analyze_batch`` at the default config on a batch that takes every
  branch of the escalation (not triggered, triggered but not used, used),
  under the shared output contract ``assert_outputs_match``. The JAX side
  runs the TPU's key-STFT path, as in ``tests/test_torch_slice.py``.
* Per-track results do not depend on which other tracks escalate with them
  (the port of ``tests/test_integration.py::test_escalation_subbatch_invariance``).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stratum_dsp_tpu.analysis import PipelineCaps as JaxCaps
from stratum_dsp_tpu.analysis import analyze_batch as jax_analyze
from stratum_dsp_tpu.config import AnalysisConfig
from stratum_dsp_tpu.features.period import multi_resolution as jmr
from stratum_dsp_tpu.testing import SAMPLE_RATE, kick_pattern, pad_batch
from stratum_dsp_tpu.testing.battery import drum_track
import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch.features.period import multi_resolution as pmr
from stratum_dsp_tpu_torch.testing import assert_outputs_match

torch.set_num_threads(2)

CFG = AnalysisConfig()
PCFG = port.AnalysisConfig.from_dict(dataclasses.asdict(CFG))  # the port's own class
CAPS = dict(max_onsets=512, max_beats=256, seg_beat_cap=32, max_segments=12)
PARITY_CASES = [  # the cases of tests/test_multires_parity.py
    ("mid_140", dict(bpm=140.0, hats="offbeat")),
    ("folddown_200", dict(bpm=200.0, hats="eighths")),
    ("foldup_75", dict(bpm=75.0, pattern="plain")),
    ("frac_113_6", dict(bpm=113.6, hats="offbeat")),
]


@pytest.fixture(scope="module")
def parity_batch():
    tracks = [drum_track(f"mrp_{name}", duration_s=20.0, **kw) for name, kw in PARITY_CASES]
    return np.stack(tracks).astype(np.float32), np.full(len(tracks), len(tracks[0]), np.int32)


@pytest.fixture(scope="module")
def jax_multires(parity_batch):
    samples, lengths = (jnp.asarray(x) for x in parity_batch)
    top_k = max(CFG.tempogram_multi_res_top_k, 1)
    est = jmr.multi_resolution_estimate(samples, lengths, CFG, SAMPLE_RATE)
    _, nov512, _, nval512 = jax.jit(
        lambda s, n: jmr.hop_candidates(s, n, CFG, SAMPLE_RATE, 512, top_k))(samples, lengths)
    return {k: np.array(v) for k, v in est.items()}, np.array(nov512), np.array(nval512)


def test_multi_resolution_estimate_matches_jax(parity_batch, jax_multires):
    ref = jax_multires[0]
    got = pmr.multi_resolution_estimate(*(torch.as_tensor(x) for x in parity_batch), PCFG,
                                        SAMPLE_RATE)
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["ok"], ref["ok"])
    assert ref["ok"].all()
    np.testing.assert_array_equal(got["method_agreement"], ref["method_agreement"])
    np.testing.assert_allclose(got["bpm"], ref["bpm"], rtol=0, atol=1e-2)
    np.testing.assert_allclose(got["confidence"], ref["confidence"], rtol=0, atol=1e-3)


def test_beat_contrast_score_matches_jax(jax_multires):
    ref_est, nov512, nval512 = jax_multires
    fams = ref_est["bpm"][:, None] * np.asarray(pmr.FAMILY_FACTORS, np.float32)
    spread = np.linspace(60.0, 190.0, 9, dtype=np.float32)[None, :].repeat(len(fams), 0)
    for cands in (fams.astype(np.float32), spread):
        ref = np.asarray(jmr.beat_contrast_score(jnp.asarray(nov512), jnp.asarray(nval512),
                                                 jnp.asarray(cands), SAMPLE_RATE, 512))
        got = pmr.beat_contrast_score(torch.as_tensor(nov512), torch.as_tensor(nval512),
                                      torch.as_tensor(cands), SAMPLE_RATE, 512).numpy()
        assert (ref != 0).any()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        # the float-period comb (beat_contrast_fractional)
        ref = np.asarray(jmr.beat_contrast_score(jnp.asarray(nov512), jnp.asarray(nval512),
                                                 jnp.asarray(cands), SAMPLE_RATE, 512,
                                                 fractional=True))
        got = pmr.beat_contrast_score(torch.as_tensor(nov512), torch.as_tensor(nval512),
                                      torch.as_tensor(cands), SAMPLE_RATE, 512,
                                      fractional=True).numpy()
        assert (ref != 0).any()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def _fixture_batch():
    """Every escalation branch: 120 and 128 not triggered, 75 triggered but
    not used, the 172 kick and the 200 BPM drum track used."""
    tracks = [kick_pattern(b, 8.0) for b in (75.0, 120.0, 128.0, 172.0)]
    tracks.append(drum_track("mr_fixture_200", bpm=200.0, duration_s=20.0, hats="eighths"))
    return pad_batch(tracks)


def _both_packages(cfg):
    """(jax outputs, port outputs) of the escalation fixture under ``cfg``."""
    samples, lengths = _fixture_batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STRATUM_FORCE_POLYPHASE", "1")
        mp.setenv("STRATUM_FORCE_PALLAS_POLY2", "1")
        jax.clear_caches()  # traces are cached by static args, not by env
        try:
            ref = {k: np.asarray(v) for k, v in
                   jax_analyze(samples, lengths, cfg, SAMPLE_RATE, JaxCaps(**CAPS)).items()}
        finally:
            jax.clear_caches()
    got = port.analyze_batch(samples, lengths,
                             port.AnalysisConfig.from_dict(dataclasses.asdict(cfg)), SAMPLE_RATE,
                             port.PipelineCaps(**CAPS), device="cpu")
    return ref, got


def test_default_config_matches_jax():
    ref, got = _both_packages(CFG)
    assert_outputs_match(ref, got)
    used, trig = got["multi_res_used"].numpy(), got["multi_res_triggered"].numpy()
    assert used.sum() >= 2 and (trig & ~used).sum() >= 1, (trig, used)


def test_fractional_beat_contrast_config_matches_jax():
    """``beat_contrast_fractional``: the float-period comb decides inside the
    escalation, on the same fixture."""
    ref, got = _both_packages(CFG.replace(beat_contrast_fractional=True))
    assert_outputs_match(ref, got)
    assert got["multi_res_triggered"].numpy().sum() >= 3


def test_escalation_subbatch_invariance():
    """A track's result does not depend on which tracks escalate with it:
    in a batch of 4 only the trap-zone tracks escalate (a gathered
    sub-batch of 2); alone, each track is its own batch."""
    bpms = [75.0, 120.0, 128.0, 172.0]
    samples, lengths = pad_batch([kick_pattern(x, 8.0) for x in bpms])
    caps = port.PipelineCaps(max_onsets=256, max_beats=256, seg_beat_cap=32, max_segments=12)
    out = port.analyze_batch(samples, lengths, PCFG, SAMPLE_RATE, caps, device="cpu")
    trig = out["multi_res_triggered"].numpy()
    assert trig[0] and trig[3] and not trig[1] and not trig[2], trig
    for i in (0, 1, 3):
        one = port.analyze_batch(samples[i:i + 1], lengths[i:i + 1], PCFG, SAMPLE_RATE, caps,
                                 device="cpu")
        assert float(one["bpm"][0]) == pytest.approx(float(out["bpm"][i]), abs=1e-4)
        assert bool(one["multi_res_used"][0]) == bool(out["multi_res_used"][i])
