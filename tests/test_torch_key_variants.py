"""The opt-in key paths of the port against the JAX package on the same numpy
inputs: the chroma / HPCP functions, the scoring and the detectors one by one,
then ``detect_key_batch`` for every key override set of
``tests/test_config_variants.py`` and the other conditionings.

Bounds: host-built tables bit-equal; tables built on the device
(``chroma_projection_dynamic``, ``hpcp_harmonic_matrix_dynamic``) 1e-6 (two
f32 ``exp`` / ``round`` chains); chroma and HPCP frames 1e-5 (the whitened
spectrum, which only ranks peaks, 5e-4 relative); detectors
``key_idx`` exact, confidence / clarity / scores 1e-4; ``detect_key_batch``
key index exact, confidence and clarity within 1e-3 of JAX (the key STFT's
bf16 bases differ by one bf16 ulp in ~0.1% of entries). The JAX side runs the
TPU's polyphase key STFT (``STRATUM_FORCE_POLYPHASE`` /
``STRATUM_FORCE_PALLAS_POLY2``), which is what the port computes."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stratum_dsp_tpu.config import AnalysisConfig as JaxConfig
from stratum_dsp_tpu.features.chroma import extractor as jchx
from stratum_dsp_tpu.features.chroma import postprocess as jpost
from stratum_dsp_tpu.features.key import detect_key_batch as jax_detect_key_batch
from stratum_dsp_tpu.features.key import detector as jdet
from stratum_dsp_tpu.features.key import scoring as jscoring
from stratum_dsp_tpu.features.key.templates import key_templates as jtemplates
from stratum_dsp_tpu.result import Key
from stratum_dsp_tpu.testing import SAMPLE_RATE, c_major_scale, pad_batch
import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch import testing as ptesting
from stratum_dsp_tpu_torch.features.chroma import extractor as pchx
from stratum_dsp_tpu_torch.features.chroma import postprocess as ppost
from stratum_dsp_tpu_torch.features.key import detector as pdet
from stratum_dsp_tpu_torch.features.key import scoring as pscoring
from stratum_dsp_tpu_torch.features.key.pipeline import detect_key_batch

torch.set_num_threads(2)
SR, N = 44100, 8192
T = torch.as_tensor
J = jnp.asarray


def port_cfg(jax_cfg):
    return port.AnalysisConfig.from_dict(dataclasses.asdict(jax_cfg))


def _close(got, ref, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=tol)


def _spectra(seed=31, shape=(2, 9, 931)):
    """Magnitude frames with a few strong partials over a noise floor."""
    rng = np.random.default_rng(seed)
    x = 0.05 * rng.random(shape).astype(np.float32)
    for k in (49, 61, 98, 122, 147, 300, 611):
        x[..., k] += rng.random(shape[:-1]).astype(np.float32) + 0.5
    return x


# ---- tables ---------------------------------------------------------------

def test_host_tables_bit_equal():
    eq = np.testing.assert_array_equal
    eq(pchx.semitones_of_bins(SR, N, 931), jchx.semitones_of_bins(SR, N, 931))
    for args in ((SR, N, True, 0.5), (SR, N, False, 0.5), (SR, 2048, True, 0.7, 0.04),
                 (SR, N, True, 0.5, -0.08, 55.0, 300.0)):
        eq(pchx.chroma_projection_matrix(*args), jchx.chroma_projection_matrix(*args))
    for args in ((SR, N, 100.0, 5000.0), (SR, 2048, 100.0, 5000.0)):
        (pw, pmin), (jw, jmin) = (pchx.log_frequency_projection(*args),
                                  jchx.log_frequency_projection(*args))
        eq(pw, jw)
        assert pmin == jmin
        eq(pchx.semitone_fold_matrix(pw.shape[1], pmin),
           jchx.semitone_fold_matrix(jw.shape[1], jmin))


@pytest.mark.parametrize("soft", [True, False])
def test_chroma_projection_dynamic_matches_jax(soft):
    t = np.asarray([0.0, 0.037, -0.08, 0.49], np.float32)
    got = pchx.chroma_projection_dynamic(SR, N, soft, 0.5, T(t))
    _close(got, jchx.chroma_projection_dynamic(SR, N, soft, 0.5, J(t)), 1e-6)
    # a zero offset gives the static table (f32 against the host's f64 chain)
    _close(got[0], jchx.chroma_projection_matrix(SR, N, soft, 0.5, 0.0), 1e-5)


def test_hpcp_harmonic_matrix_dynamic_matches_jax():
    t = np.asarray([0.0, 0.05, -0.08], np.float32)
    args = (SR, N, 931, 0.5)
    rest = (4, 0.6, 100.0, 5000.0)
    got = pchx.hpcp_harmonic_matrix_dynamic(*args, T(t), *rest)
    _close(got, jchx.hpcp_harmonic_matrix_dynamic(*args, J(t), *rest), 1e-6)
    _close(got[0], jchx.hpcp_harmonic_matrix(*args, 0.0, *rest), 1e-5)


# ---- chroma / HPCP frames --------------------------------------------------

def test_frames_to_chroma_and_whitening_match_jax():
    x = _spectra()
    proj = jchx.chroma_projection_matrix(SR, N, True, 0.5)[:931]
    _close(pchx.frames_to_chroma(T(x), T(proj)), jchx.frames_to_chroma(J(x), J(proj)), 1e-5)
    # the local mean is a difference of two f32 prefix sums over up to 931
    # bins, and the two libraries scan in different orders: 5e-4 relative. The
    # whitened spectrum only ranks the peaks; the HPCP weights are the raw ones.
    for bins in (3, 31, 64):
        np.testing.assert_allclose(pchx.spectral_whiten(T(x), bins).numpy(),
                                   np.asarray(jchx.spectral_whiten(J(x), bins)), rtol=5e-4)


HPCP_ARGS = (SR, N, 0.5)
HPCP_REST = (24, 4, 0.6, 0.5)


@pytest.mark.parametrize("approx", [True, False], ids=["threshold", "exact"])
@pytest.mark.parametrize("kw", [
    {}, dict(enable_whitening=True, whitening_smooth_bins=31),
    dict(fmin_hz=55.0, fmax_hz=300.0), dict(fmin_hz=100.0, fmax_hz=140.0),
], ids=["plain", "whitened", "bass-band", "tiny-band"])
@pytest.mark.parametrize("tuning", [0.0, "per-track"])
def test_frames_to_hpcp_matches_jax(approx, kw, tuning):
    """The threshold and the exact peak selection; the tiny band takes the
    exact path's plain top-k branch (more peaks asked for than half its bins)."""
    x = _spectra(seed=32)
    x[0, 0] = 0.0  # an empty frame stays zero
    x[1, 1, 200:240] = 0.75  # a plateau: ties among the peaks' neighbours
    tj = tt = tuning
    if tuning == "per-track":
        t = np.asarray([0.03, -0.07], np.float32)
        tj, tt = J(t), T(t)
    got = pchx.frames_to_hpcp(T(x), *HPCP_ARGS, tt, *HPCP_REST, approx_peaks=approx, **kw)
    ref = jchx.frames_to_hpcp(J(x), *HPCP_ARGS, tj, *HPCP_REST, approx_peaks=approx, **kw)
    assert got.shape == (2, 9, 12) and not got[0, 0].any()
    _close(got, ref, 1e-5)


def test_exact_peak_selection_ties_go_to_the_lower_bin():
    """Equal peaks beyond the k-th: the exact path keeps the lower bins, as a
    stable sort does."""
    x = np.zeros((1, 1, 931), np.float32)
    x[..., 100:400:10] = 1.0  # 30 equal peaks, 24 are kept
    got = pchx.frames_to_hpcp(T(x), *HPCP_ARGS, 0.0, *HPCP_REST, approx_peaks=False)
    ref = jchx.frames_to_hpcp(J(x), *HPCP_ARGS, 0.0, *HPCP_REST, approx_peaks=False)
    _close(got, ref, 1e-6)


def test_hpss_mask_tuning_beat_sync_and_average_match_jax():
    rng = np.random.default_rng(33)
    band = rng.random((2, 30, 64)).astype(np.float32)
    counts = np.asarray([30, 19])
    _close(pchx.hpss_median_mask_downsampled(T(band), T(counts), 8, 8, 2.0),
           jchx.hpss_median_mask_downsampled(J(band), J(counts), 8, 8, 2.0), 1e-6)

    x = _spectra(seed=34, shape=(2, 45, 931))
    fvalid = np.arange(45)[None, :] < np.asarray([45, 31])[:, None]
    x = np.where(fvalid[..., None], x, 0.0).astype(np.float32)
    args = (SR, N, 80.0, 2000.0, 4, 0.35)
    _close(pchx.estimate_tuning_offset(T(x), T(fvalid), *args),
           jchx.estimate_tuning_offset(J(x), J(fvalid), *args), 1e-5)

    chroma = rng.random((2, 45, 12)).astype(np.float32)
    energy = rng.random((2, 45)).astype(np.float32)
    beats = np.zeros((2, 8), np.float32)
    beats[0, :6] = 0.05 + 0.09 * np.arange(6)
    beats[1, :3] = (0.2, 0.21, 0.4)  # an interval without a frame
    bvalid = np.arange(8)[None, :] < np.asarray([6, 3])[:, None]
    got = pchx.beat_synchronous_chroma(T(chroma), T(energy), T(fvalid), T(beats), T(bvalid),
                                       SR / 512)
    ref = jchx.beat_synchronous_chroma(J(chroma), J(energy), J(fvalid), J(beats), J(bvalid),
                                       SR / 512)
    _close(got[0], ref[0], 1e-6)
    _close(got[1], ref[1], 1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))

    for window in (1, 4, 9):
        _close(ppost.smooth_chroma_average(T(chroma), T(counts), window),
               jpost.smooth_chroma_average(J(chroma), J(counts), window), 1e-6)


# ---- scoring and detectors --------------------------------------------------

def _chroma_batch(seed=35, b=3, f=400):
    """Chroma frames that lean to one key per track, ragged, with weights."""
    rng = np.random.default_rng(seed)
    tpl = jtemplates(JaxConfig().key_template_set)
    keys = (0, 14, 19)
    chroma = 0.4 * rng.random((b, f, 12)).astype(np.float32)
    for i, k in enumerate(keys[:b]):
        chroma[i] += tpl[k] / tpl[k].max()
        chroma[i, f // 2:] += 0.5 * tpl[(k + 7) % 24] / tpl[(k + 7) % 24].max()
    counts = np.asarray([f, f - 137, 90][:b])
    fvalid = np.arange(f)[None, :] < counts[:, None]
    chroma = np.where(fvalid[..., None], chroma, 0.0).astype(np.float32)
    weights = np.where(fvalid, rng.random((b, f)) + 0.1, 0.0).astype(np.float32)
    return chroma, weights, fvalid.astype(np.float32), counts


def _same_result(got, ref):
    np.testing.assert_array_equal(got.key_idx.numpy(), np.asarray(ref.key_idx))
    for name in ("confidence", "clarity", "scores"):
        _close(getattr(got, name), getattr(ref, name), 1e-4)


def test_scoring_functions_match_jax():
    chroma, weights, _, _ = _chroma_batch()
    tpl = jtemplates(JaxConfig().key_template_set)
    raw = pscoring.raw_scores(T(chroma), T(weights), T(tpl))
    ref = jscoring.raw_scores(J(chroma), J(weights), J(tpl))
    np.testing.assert_allclose(raw.numpy(), np.asarray(ref), rtol=1e-5)
    scores = np.asarray(jscoring.finalize_scores(ref))
    idx = np.asarray([3, 12, 23])
    scores = scores.copy()
    _close(pscoring.confidence_for_key(T(scores), T(idx)),
           jscoring.confidence_for_key(J(scores), J(idx)), 1e-6)
    avg = np.einsum("bf,bfc->bc", weights, chroma)
    wsum = weights.sum(-1)
    for args in ((0.0, 0.6, False, 0.2), (0.1, 0.6, True, 0.2), (0.0, 0.0, True, 0.05),
                 (0.0, 1.0, False, 0.0)):
        got = pscoring.mode_heuristic(T(scores), T(avg), T(wsum), *args)
        want = jscoring.mode_heuristic(J(scores), J(avg), J(wsum), *args)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        _close(got[1], want[1], 1e-5)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5)


@pytest.mark.parametrize("overrides", [
    {}, dict(enable_key_mode_heuristic=True), dict(enable_key_minor_harmonic_bonus=True),
    dict(enable_key_mode_heuristic=True, enable_key_minor_harmonic_bonus=True,
         key_mode_third_ratio_margin=0.05),
], ids=["plain", "mode-heuristic", "minor-bonus", "both"])
@pytest.mark.parametrize("name", ["weighted", "segment_voting", "multi_scale", "median",
                                  "ensemble"])
def test_detectors_match_jax(name, overrides):
    jcfg = JaxConfig(key_segment_len_frames=120, key_segment_hop_frames=60,
                     key_multi_scale_lengths=(60, 120, 500), key_multi_scale_hop=30,
                     key_multi_scale_weights=(1.0, 2.0), key_median_segment_length_frames=120,
                     key_median_segment_hop_frames=40, **overrides)
    cfg = port_cfg(jcfg)
    chroma, weights, mask, counts = _chroma_batch()
    pa, ja = (T(chroma), T(weights), T(mask)), (J(chroma), J(weights), J(mask))
    if name in ("weighted", "ensemble"):
        got = getattr(pdet, f"detect_key_{name}")(*pa, cfg)
        ref = getattr(jdet, f"detect_key_{name}")(*ja, jcfg)
    else:
        got = getattr(pdet, f"detect_key_{name}")(*pa, T(counts), cfg)
        ref = getattr(jdet, f"detect_key_{name}")(*ja, J(counts), jcfg)
    _same_result(got, ref)
    if not jcfg.enable_key_minor_harmonic_bonus:
        assert got.key_idx.tolist()[0] in (0, 7)  # the planted key or its dominant


def test_median_and_changes_take_the_first_of_tied_keys():
    """Two keys chosen by equally many segments with equal confidence: the
    lower index wins, as ``jnp.argmax`` gives it."""
    key_idx = T(np.asarray([[5, 2, 5, 2]]))
    conf = T(np.asarray([[0.5, 0.5, 0.5, 0.5]], np.float32))
    valid = torch.ones((1, 4), dtype=torch.bool)
    assert pdet._most_frequent_key(key_idx, conf, valid).tolist() == [2]
    assert pdet._first_argmax(T(np.asarray([[1.0, 3.0, 3.0, 2.0]]))).tolist() == [1]


def test_detect_key_changes_matches_jax():
    chroma, weights, mask, counts = _chroma_batch()
    jcfg = JaxConfig()
    got = pdet.detect_key_changes(T(chroma), T(weights), T(mask), T(counts), port_cfg(jcfg),
                                  SR / 512, 1.5, 0.5)
    ref = jdet.detect_key_changes(J(chroma), J(weights), J(mask), J(counts), jcfg, SR / 512,
                                  1.5, 0.5)
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    _close(got[2], ref[2], 1e-4)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))


# ---- the key path as a whole -------------------------------------------------

@pytest.fixture(scope="module")
def polyphase_jax():
    """The JAX package on the TPU's key-STFT path for this module's calls
    (traces are cached by static args, not by environment)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STRATUM_FORCE_POLYPHASE", "1")
        mp.setenv("STRATUM_FORCE_PALLAS_POLY2", "1")
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


def _scale_batch():
    """The C-major scale, and its first six notes as a shorter second row."""
    scale = c_major_scale()
    return pad_batch([scale, scale[:3 * SAMPLE_RATE]])


KEY_VARIANTS = [
    # the eleven override sets of tests/test_config_variants.py
    ({"enable_key_log_frequency": True, "enable_key_hpcp": False}, "C"),
    ({"enable_key_tuning_compensation": True}, "C"),
    ({"enable_key_hpss_harmonic": True, "enable_key_harmonic_mask": False}, "C"),
    ({"enable_key_ensemble": True}, "C"),
    ({"enable_key_median": True, "enable_key_segment_voting": False,
      "key_median_segment_length_frames": 120, "key_median_segment_hop_frames": 30}, "C"),
    ({"enable_key_mode_heuristic": True, "key_mode_flip_min_score_ratio": 0.6}, "C"),
    ({"enable_key_hpcp_whitening": True}, "C"),
    ({"enable_key_hpcp": False}, "C"),
    ({"enable_key_multi_scale": True, "key_multi_scale_lengths": (60, 120)}, "C"),
    ({"enable_key_hpcp_bass_blend": True}, "C"),
    ({"enable_key_edge_trim": True}, "G"),
    # the other conditionings, STFT sizes, selections and combinations
    ({"enable_key_stft_override": False}, "C"),
    ({"enable_key_harmonic_mask": False}, "C"),
    ({"enable_key_harmonic_mask": False, "enable_key_spectrogram_time_smoothing": False}, "C"),
    ({"enable_key_minor_harmonic_bonus": True}, "Cm"),
    ({"key_hpcp_approx_peaks": False}, "C"),
    ({"key_hpcp_approx_peaks": False, "enable_key_tuning_compensation": True,
      "enable_key_hpcp_bass_blend": True, "enable_key_hpcp_whitening": True}, "C"),
    ({"enable_key_hpcp": False, "enable_key_tuning_compensation": True}, "C"),
    ({"enable_key_segment_voting": False, "enable_key_frame_weighting": False,
      "stft_bf16": False}, "C"),
]


def _variant_id(case):
    return "+".join(k.replace("enable_key_", "").replace("key_", "") for k in case[0])


@pytest.mark.parametrize("overrides,expected", KEY_VARIANTS, ids=map(_variant_id, KEY_VARIANTS))
def test_detect_key_batch_variants_match_jax(polyphase_jax, overrides, expected):
    samples, lengths = _scale_batch()
    jcfg = JaxConfig(**overrides)
    ref = jax_detect_key_batch(J(samples), J(lengths), jcfg, SAMPLE_RATE)
    got = detect_key_batch(T(samples), T(lengths), port_cfg(jcfg), SAMPLE_RATE)
    np.testing.assert_array_equal(got.key_idx.numpy(), np.asarray(ref.key_idx))
    assert Key.from_index(int(got.key_idx[0])).name() == expected
    # Queue 3: the leading-tone bonus amplifies the chroma's 1e-4 differences
    tol = ptesting.LEADING_TONE_BONUS_TOL if "enable_key_minor_harmonic_bonus" in overrides \
        else ptesting.FLOAT_TOL
    _close(got.confidence, ref.confidence, tol)
    _close(got.clarity, ref.clarity, tol)


@pytest.mark.parametrize("extra", [{}, {"enable_key_tuning_compensation": True,
                                        "enable_key_hpss_harmonic": True}],
                         ids=["plain", "tuned-hpss"])
def test_beat_synchronous_key_matches_jax(polyphase_jax, extra):
    """A synthetic beat grid: a beat every half second on the first row, an
    irregular shorter one on the second. The intervals become the frames."""
    samples, lengths = _scale_batch()
    beats = np.zeros((2, 16), np.float32)
    beats[0, :8] = 0.25 + 0.5 * np.arange(8)
    beats[1, :5] = (0.1, 0.7, 0.9, 1.8, 2.6)
    bvalid = np.arange(16)[None, :] < np.asarray([8, 5])[:, None]
    jcfg = JaxConfig(enable_key_beat_synchronous=True, **extra)
    ref = jax_detect_key_batch(J(samples), J(lengths), jcfg, SAMPLE_RATE, J(beats), J(bvalid))
    got = detect_key_batch(T(samples), T(lengths), port_cfg(jcfg), SAMPLE_RATE, T(beats),
                           T(bvalid))
    np.testing.assert_array_equal(got.key_idx.numpy(), np.asarray(ref.key_idx))
    _close(got.confidence, ref.confidence, ptesting.FLOAT_TOL)
    _close(got.clarity, ref.clarity, ptesting.FLOAT_TOL)
    # without beats the flag changes nothing
    plain = detect_key_batch(T(samples), T(lengths), port_cfg(jcfg), SAMPLE_RATE)
    base = detect_key_batch(T(samples), T(lengths),
                            port_cfg(jcfg.replace(enable_key_beat_synchronous=False)), SAMPLE_RATE)
    np.testing.assert_array_equal(plain.scores.numpy(), base.scores.numpy())
