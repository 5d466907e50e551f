"""The port's ``preprocessing/normalization.py`` against
``stratum_dsp_tpu/preprocessing/normalization.py`` on the same numpy inputs.

Host-built tables (biquad coefficients, FIR taps, the Toeplitz matrix) are
bit-equal. Samples agree within 1e-6 relative, ``measured_lufs`` and
``gain_db`` within 1e-3 dB (two f32 ``log10`` / ``pow`` implementations and
the summation order of the block means), and -inf stands where JAX has it."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stratum_dsp_tpu.config import NormalizationMethod as JaxMethod
from stratum_dsp_tpu.preprocessing import normalization as jn
from stratum_dsp_tpu_torch.config import NormalizationMethod
from stratum_dsp_tpu_torch.preprocessing import normalization as pn

torch.set_num_threads(2)
SR = 44100


def _ragged_batch():
    """Noise at a normal level, a row that clips, a silent row, a row below
    the -70 LUFS gate, and a short row."""
    rng = np.random.default_rng(11)
    t = 3 * SR
    x = np.zeros((5, t), np.float32)
    lengths = np.asarray([t, t - 5000, t, t, SR // 3])
    x[0] = 0.1 * rng.standard_normal(t)
    x[1] = np.clip(1.5 * rng.standard_normal(t), -1.6, 1.6)
    x[3] = 1e-5 * rng.standard_normal(t)
    x[4, :lengths[4]] = 0.3 * np.sin(2 * np.pi * 220.0 * np.arange(lengths[4]) / SR)
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
    return x, lengths


@pytest.mark.parametrize("sr", [44100.0, 48000.0, 22050.0])
def test_host_tables_bit_equal(sr):
    assert pn.k_weighting_coeffs(sr) == jn.k_weighting_coeffs(sr)
    np.testing.assert_array_equal(pn.k_weighting_fir(sr), jn.k_weighting_fir(sr))
    np.testing.assert_array_equal(pn._k_weighting_toeplitz(sr), jn._k_weighting_toeplitz(sr))
    assert pn.KWEIGHT_FIR_TAPS == jn.KWEIGHT_FIR_TAPS


def test_k_weighting_filter_matches_jax():
    x, _ = _ragged_batch()
    x = x[:, :SR + 77]  # not a multiple of the block
    got = pn.k_weighting_filter(torch.as_tensor(x), SR).numpy()
    ref = np.asarray(jn.k_weighting_filter(jnp.asarray(x), SR))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_lufs_matches_jax_and_gates():
    x, lengths = _ragged_batch()
    got = pn.calculate_lufs(torch.as_tensor(x), torch.as_tensor(lengths), SR).numpy()
    ref = np.asarray(jn.calculate_lufs(jnp.asarray(x), jnp.asarray(lengths), SR))
    assert np.isneginf(ref[2]) and np.isneginf(ref[3])  # silent, and below the gate
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    np.testing.assert_allclose(got[np.isfinite(ref)], ref[np.isfinite(ref)], atol=1e-3)


@pytest.mark.parametrize("method", ["peak", "rms", "loudness"])
def test_normalize_matches_jax(method):
    x, lengths = _ragged_batch()
    got, gmeta = pn.normalize(torch.as_tensor(x), torch.as_tensor(lengths),
                              NormalizationMethod(method), SR)
    ref, rmeta = jn.normalize(jnp.asarray(x), jnp.asarray(lengths), JaxMethod(method), SR)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-9)
    assert set(gmeta) == set(rmeta) == {"peak_db", "rms_db", "gain_db", "measured_lufs"}
    for k, r in rmeta.items():
        g, r = gmeta[k].numpy(), np.asarray(r)
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(r), err_msg=k)
        np.testing.assert_allclose(g[np.isfinite(r)], r[np.isfinite(r)], atol=1e-3, err_msg=k)
    # the silent row keeps gain 1; no row ends above full scale
    assert float(gmeta["gain_db"][2]) == 0.0
    assert float(got.abs().max()) <= 1.0 + 1e-6
    if method == "loudness":
        assert np.isfinite(np.asarray(rmeta["measured_lufs"])[[0, 1, 4]]).all()


def test_normalize_peak_is_the_peak_branch():
    x, lengths = _ragged_batch()
    tx, tn = torch.as_tensor(x), torch.as_tensor(lengths)
    np.testing.assert_array_equal(
        pn.normalize_peak(tx, tn).numpy(),
        pn.normalize(tx, tn, NormalizationMethod.PEAK, SR)[0].numpy())
