"""The opt-in BPM-side configurations through the whole pipeline:
``stratum_dsp_tpu_torch.analyze_batch`` on the CPU against the JAX package's
``analyze_batch`` under the port's output contract
(``stratum_dsp_tpu_torch.testing.assert_outputs_match``), on kicks at 75, 120
and 172 BPM. The override sets are those of ``tests/test_config_variants.py``
that run no HPSS (those are in ``tests/test_torch_hpss_pipeline.py`` and
``tests/test_torch_hpss.py``), and RMS and LOUDNESS normalization. They keep
the escalation off: it is not what they are about, and the JAX side compiles
each config anew (``beat_contrast_fractional``, which is about the escalation,
is in ``tests/test_torch_multires.py``)."""

import pytest
import torch

from stratum_dsp_tpu.config import NormalizationMethod
from torch_port_reference import run_both

torch.set_num_threads(2)
NO_ESCALATION = {"enable_tempogram_multi_resolution": False}


@pytest.mark.parametrize("overrides", [
    {"enable_bpm_fusion": True},
    {"force_legacy_bpm": True},
    {"enable_key_beat_synchronous": True},
    {"enable_onset_consensus": False},
    {"enable_normalization": False, "enable_silence_trimming": False},
    {"normalization": NormalizationMethod.RMS},
    {"normalization": NormalizationMethod.LOUDNESS},
], ids=["bpm-fusion", "forced-legacy", "beat-synchronous-key", "no-consensus",
        "no-normalization-no-trim", "rms", "loudness"])
def test_pipeline_variant_matches_jax(overrides):
    ref, got = run_both({**NO_ESCALATION, **overrides})
    if overrides.get("force_legacy_bpm"):
        # tempo_valid carries ~force_legacy_bpm, and legacy_used follows it
        assert got["legacy_used"].all() and ref["legacy_used"].all()
    else:
        assert not got["legacy_used"].any()
    assert not got["percussive_triggered"].any() and not got["percussive_used"].any()


def test_fusion_changes_the_confidence_only():
    """Fusion rescales the tempogram's confidence by the legacy estimate's
    agreement; the BPM choice stays."""
    _, plain = run_both(NO_ESCALATION)
    _, fused = run_both({**NO_ESCALATION, "enable_bpm_fusion": True})
    assert (plain["bpm"] == fused["bpm"]).all()
    assert (plain["bpm_confidence"] != fused["bpm_confidence"]).any()
