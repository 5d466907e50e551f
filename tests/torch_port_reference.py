"""What ``tests/test_torch_results.py`` and ``tests/test_torch_cli.py`` share:
one batch of tracks whose samples are exactly what a 16-bit WAV holds, and
the JAX package's output for it, computed once per process.

The JAX side runs one configuration only, the default one with
``emit_tempogram_candidates`` and ``debug_track_id`` set: those settings add
outputs and change none, so the default configuration's output is the same
dict without the ``cand_*`` and ``dbg_*`` keys, and one compile of the
pipeline serves both files (the persistent cache hands it from one worker to
the next). The capacities are the CLIs' defaults. As in the other port
tests, the JAX side takes the TPU's key-STFT path.
"""

import dataclasses
import functools

import numpy as np
import pytest

SAMPLE_RATE = 44100
DEBUG_KEY_PREFIXES = ("cand_", "dbg_")
FLOAT_FIELDS = ("bpm", "bpm_confidence", "key_confidence", "key_clarity", "grid_stability",
                "duration_seconds")
TRACK_NAMES = ("kick_75", "kick_120", "kick_172", "c_major_scale")


@functools.lru_cache(maxsize=1)
def tracks16():
    """The tracks as int16 [4, T], all of one length (8 s): three kicks that
    take every branch of the escalation, and the C-major scale tiled."""
    from stratum_dsp_tpu.testing import c_major_scale, kick_pattern

    tracks = [kick_pattern(bpm, 8.0) for bpm in (75.0, 120.0, 172.0)]
    scale = c_major_scale()
    tracks.append(np.tile(scale, -(-len(tracks[0]) // len(scale)))[:len(tracks[0])])
    return np.stack([(np.clip(x, -1.0, 1.0) * 32767.0).astype(np.int16) for x in tracks])


def batch():
    """``(samples [4, T] f32, lengths [4])``: what decoding those 16-bit
    files gives, sample for sample."""
    x = tracks16().astype(np.float32) / np.float32(32768.0)
    return x, np.full(len(x), x.shape[1], np.int32)


def jax_debug_config():
    from stratum_dsp_tpu.config import AnalysisConfig

    return AnalysisConfig(emit_tempogram_candidates=True, debug_track_id=0)


def port_config(jax_cfg):
    import stratum_dsp_tpu_torch as port

    return port.AnalysisConfig.from_dict(dataclasses.asdict(jax_cfg))


@functools.lru_cache(maxsize=1)
def jax_debug_output():
    """The JAX package's result dict (numpy) for ``batch()`` under
    ``jax_debug_config()`` and the default capacities."""
    import jax
    from stratum_dsp_tpu.analysis import analyze_batch

    samples, lengths = batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STRATUM_FORCE_POLYPHASE", "1")
        mp.setenv("STRATUM_FORCE_PALLAS_POLY2", "1")
        jax.clear_caches()  # traces are cached by static args, not by env
        try:
            out = analyze_batch(samples, lengths, jax_debug_config(), SAMPLE_RATE)
            return {k: np.asarray(v) for k, v in out.items()}
        finally:
            jax.clear_caches()


def without_debug_keys(out: dict) -> dict:
    return {k: v for k, v in out.items() if not k.startswith(DEBUG_KEY_PREFIXES)}


def assert_dicts_match(ref: dict, got: dict, skip=()) -> None:
    """Two ``to_dict()`` results: equal keys, floats within the output
    contract's bounds (``stratum_dsp_tpu_torch.testing``), everything else
    exactly; ``skip`` names keys whose values are not compared."""
    from stratum_dsp_tpu_torch.testing import BPM_TOL, FLOAT_TOL

    assert list(got) == list(ref)
    for k, want in ref.items():
        if k in skip:
            continue
        if k in FLOAT_FIELDS:
            assert got[k] == pytest.approx(want, abs=BPM_TOL if k == "bpm" else FLOAT_TOL), k
        elif k == "tempogram_candidates" and want is not None:
            assert len(got[k]) == len(want)
            for g, w in zip(got[k], want):
                assert g["selected"] == w["selected"]
                assert g["bpm"] == pytest.approx(w["bpm"], abs=BPM_TOL)
                for f in ("score", "fft_norm", "autocorr_norm"):
                    assert g[f] == pytest.approx(w[f], abs=FLOAT_TOL), f
        else:
            assert got[k] == want, (k, got[k], want)


# The pipeline-variant tests (``tests/test_torch_bpm_variants.py``,
# ``tests/test_torch_hpss_pipeline.py``): one batch of kicks through the JAX
# package and through the port on the CPU, held to each other.
VARIANT_CAPS = dict(max_onsets=256, max_beats=256, seg_beat_cap=32, max_segments=12)
KICK_BPMS = (75.0, 120.0, 172.0)  # the low trap, a core tempo, the high trap


def kick_batch(seconds: float = 6.0):
    from stratum_dsp_tpu.testing import kick_pattern, pad_batch

    return pad_batch([kick_pattern(bpm, seconds) for bpm in KICK_BPMS])


def run_both(overrides: dict, seconds: float = 6.0):
    """(jax outputs, port outputs) as numpy dicts for the default config with
    ``overrides``, after holding the port's to the JAX package's: bools, ints
    and counts exactly, BPM to 1e-2, the other floats to 1e-3; a time
    signature whose hypotheses tie on a perfectly regular grid is held to the
    tied set (ROADMAP.md Queue 3)."""
    import jax
    from stratum_dsp_tpu.analysis import PipelineCaps as JaxCaps
    from stratum_dsp_tpu.analysis import analyze_batch as jax_analyze
    from stratum_dsp_tpu.config import AnalysisConfig
    import stratum_dsp_tpu_torch as port
    from stratum_dsp_tpu_torch.testing import assert_outputs_match

    samples, lengths = kick_batch(seconds)
    cfg = AnalysisConfig(**overrides)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STRATUM_FORCE_POLYPHASE", "1")
        mp.setenv("STRATUM_FORCE_PALLAS_POLY2", "1")
        jax.clear_caches()  # traces are cached by static args, not by env
        try:
            ref = {k: np.asarray(v) for k, v in
                   jax_analyze(samples, lengths, cfg, SAMPLE_RATE, JaxCaps(**VARIANT_CAPS)).items()}
        finally:
            jax.clear_caches()
    got = port.analyze_batch(samples, lengths,
                             port.AnalysisConfig.from_dict(dataclasses.asdict(cfg)), SAMPLE_RATE,
                             port.PipelineCaps(**VARIANT_CAPS), device="cpu")
    got = {k: v.numpy() for k, v in got.items()}
    assert_outputs_match(ref, got, allow_ts_ties=True)
    assert got["ok"].all()
    # +-2 BPM of the seed on the 120 BPM kick in every variant, no metrical
    # family allowed (the bar of tests/test_config_variants.py)
    assert abs(float(got["bpm"][1]) - 120.0) <= 2.0, got["bpm"]
    return ref, got
