"""The port's HPSS (``features/onset/hpss.py``), the reducer over a whole
spectrogram (``novelty.compute_bpm_features_from_spec``) and the two utilities
``find_peaks`` / ``adaptive_threshold_median_mad`` against the JAX package on
the same numpy inputs.

``percussive_energy_flux`` is exact in shape and within 1e-6 of the largest
frame energy. ``hpss_decompose`` is a chain of exact medians and one division per
iteration: 1e-5 relative after ten iterations. The reducer's features are
held to 1e-5 relative of each feature's largest value, the bound of
``tests/test_torch_novelty.py``. The two utilities are exact."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stratum_dsp_tpu.config import AnalysisConfig as JaxConfig
from stratum_dsp_tpu.features.onset import hpss as jhpss
from stratum_dsp_tpu.features.onset import threshold as jthr
from stratum_dsp_tpu.features.period import novelty as jnov
from stratum_dsp_tpu.features.period import peak_picking as jpeaks
import stratum_dsp_tpu_torch as port
from stratum_dsp_tpu_torch.features.onset import hpss as phpss
from stratum_dsp_tpu_torch.features.onset import threshold as pthr
from stratum_dsp_tpu_torch.features.period import novelty as pnov
from stratum_dsp_tpu_torch.features.period import peak_picking as ppeaks
from stratum_dsp_tpu_torch.ops import masked as pm

torch.set_num_threads(2)


def _spec(seed=21, shape=(2, 48, 65)):
    """Noise with a few steady partials (harmonic) and broadband frames
    (percussive), ragged in time."""
    rng = np.random.default_rng(seed)
    x = 0.1 * rng.random(shape).astype(np.float32)
    x[:, :, [5, 17, shape[2] // 2 + 8]] += 1.0
    x[:, ::8, :] += 0.7
    counts = np.asarray([shape[1], shape[1] - 13][:shape[0]])
    for i, n in enumerate(counts):
        x[i, n:] = 0.0
    return x, counts


@pytest.mark.parametrize("margin", [3, 10])
def test_hpss_decompose_matches_jax(margin):
    x, counts = _spec()
    h, p = phpss.hpss_decompose(torch.as_tensor(x), torch.as_tensor(counts), margin)
    rh, rp = jhpss.hpss_decompose(jnp.asarray(x), jnp.asarray(counts), margin)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(rp), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose((h + p).numpy(), x, rtol=1e-6, atol=1e-7)  # H + P == |X|
    # the steady partials are harmonic, the broadband frames percussive
    assert float(h[0, 3, 17]) > float(p[0, 3, 17]) and float(p[0, 8, 30]) > float(h[0, 8, 30])


def test_hpss_does_not_depend_on_the_median_slab(monkeypatch):
    x, counts = _spec(shape=(2, 24, 33))
    ref = phpss.hpss_decompose(torch.as_tensor(x), torch.as_tensor(counts), 4, iterations=3)
    monkeypatch.setattr(pm, "MEDIAN_SLAB_ELEMENTS", 500)
    got = phpss.hpss_decompose(torch.as_tensor(x), torch.as_tensor(counts), 4, iterations=3)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


def test_percussive_energy_flux_matches_jax():
    x, counts = _spec()
    flux, n = phpss.percussive_energy_flux(torch.as_tensor(x), torch.as_tensor(counts))
    rflux, rn = jhpss.percussive_energy_flux(jnp.asarray(x), jnp.asarray(counts))
    assert flux.shape == rflux.shape == (2, 47)
    np.testing.assert_array_equal(n.numpy(), np.asarray(rn))
    # a difference of neighbouring frame energies: 1e-6 of the largest energy
    e_max = float((x * x).sum(-1).max())
    np.testing.assert_allclose(flux.numpy(), np.asarray(rflux), rtol=0, atol=1e-6 * e_max)


@pytest.mark.parametrize("variant", [{}, dict(enable_tempogram_band_fusion=False,
                                               enable_tempogram_mel_novelty=False)],
                         ids=["default", "full-band"])
def test_features_from_spec_match_jax(variant):
    """One call of the reducer over the whole spectrogram with a zero carry,
    as the percussive fallback makes it (no stride 2, no onset flux)."""
    jcfg = JaxConfig(**variant)
    cfg = port.AnalysisConfig.from_dict(dataclasses.asdict(jcfg))
    x, counts = _spec(seed=22, shape=(2, 40, 1025))
    got = pnov.compute_bpm_features_from_spec(torch.as_tensor(x), torch.as_tensor(counts), cfg,
                                              44100, 2048, emit_stride2=False,
                                              emit_onset_flux=False)
    ref = jnov.compute_bpm_features_from_spec(jnp.asarray(x), jnp.asarray(counts), jcfg, 44100,
                                              2048, emit_stride2=False, emit_onset_flux=False)
    assert set(got) == set(ref) and got["band_names"] == ref["band_names"]
    for k, r in ref.items():
        if k == "band_names":
            continue
        r = np.asarray(r)
        assert got[k].shape == r.shape, k
        np.testing.assert_allclose(got[k].numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(),
                                   err_msg=k)
    assert not got["superflux"][1, counts[1]:].any()  # frames past the count are zeroed


@pytest.mark.parametrize("threshold,min_distance", [(0.0, 0), (0.0, 1), (0.3, 4), (2.0, 3)])
def test_find_peaks_exact(threshold, min_distance):
    rng = np.random.default_rng(23)
    x = np.round(rng.random((4, 41)).astype(np.float32) * 8) / 8  # ties
    valid = np.arange(41)[None, :] < np.asarray([41, 30, 2, 0])[:, None]
    got = ppeaks.find_peaks(torch.as_tensor(x), torch.as_tensor(valid), threshold, min_distance)
    ref = jpeaks.find_peaks(jnp.asarray(x), jnp.asarray(valid), threshold, min_distance)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_adaptive_thresholds_match_jax():
    rng = np.random.default_rng(24)
    x = rng.random((3, 30)).astype(np.float32)
    valid = np.arange(30)[None, :] < np.asarray([30, 17, 1])[:, None]
    got = pthr.adaptive_threshold_median_mad(torch.as_tensor(x), torch.as_tensor(valid), 1.5)
    ref = jthr.adaptive_threshold_median_mad(jnp.asarray(x), jnp.asarray(valid), 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    got = pthr.adaptive_threshold_median_mad_windowed(torch.as_tensor(x), 7, 2.0)
    ref = jthr.adaptive_threshold_median_mad_windowed(jnp.asarray(x), 7, 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_hpss_onsets_match_jax():
    """The HPSS onset detector as the consensus's fourth voter, through the
    whole pipeline against the JAX package (``tests/torch_port_reference.py``)."""
    from torch_port_reference import run_both

    ref, got = run_both({"enable_tempogram_multi_resolution": False, "enable_hpss_onsets": True})
    assert got["onset_consensus_used"].all()
    assert (got["onset_count"] == ref["onset_count"]).all()
