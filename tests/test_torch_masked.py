"""The masked-array helpers the opt-in paths added to the port's
``ops/masked.py``, against ``stratum_dsp_tpu/ops/masked.py`` on the same
numpy inputs. The three median filters return selections from their input (or
the mean of two), so they are held exactly; the rest is exact too."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stratum_dsp_tpu.ops import masked as jm
from stratum_dsp_tpu.features.chroma import postprocess as jpost
from stratum_dsp_tpu_torch.ops import masked as pm

torch.set_num_threads(2)


def _rows(seed, shape, ties=False):
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    return np.round(x * 4) / 4 if ties else x  # few distinct values: many ties


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("half", [1, 2, 5])
@pytest.mark.parametrize("ties", [False, True])
def test_median_filter_1d_exact(half, ties):
    x = _rows(1, (3, 4, 37), ties)
    _eq(pm.median_filter_1d(torch.as_tensor(x), half), jm.median_filter_1d(jnp.asarray(x), half))


@pytest.mark.parametrize("half", [1, 3, 10])
@pytest.mark.parametrize("ties", [False, True])
def test_masked_median_filter_1d_exact_on_ragged_rows(half, ties):
    """Even windows average the two middle values; entries past each row's
    valid length come back unchanged; a row with nothing valid is unchanged."""
    x = _rows(2, (5, 3, 29), ties)
    nv = np.asarray([29, 17, 1, 0, 6])[:, None]
    got = pm.masked_median_filter_1d(torch.as_tensor(x), torch.as_tensor(nv), half)
    _eq(got, jm.masked_median_filter_1d(jnp.asarray(x), jnp.asarray(nv), half))
    np.testing.assert_array_equal(got.numpy()[1, :, 17:], x[1, :, 17:])
    np.testing.assert_array_equal(got.numpy()[3], x[3])


@pytest.mark.parametrize("slab", [1, 100, 29 * 7 * 3, 10 ** 9])
def test_masked_median_filter_does_not_depend_on_the_slab(monkeypatch, slab):
    x = torch.as_tensor(_rows(3, (4, 6, 29), True))
    nv = torch.as_tensor([[29], [11], [2], [20]])
    ref = pm.masked_median_filter_1d(x, nv, 3)
    monkeypatch.setattr(pm, "MEDIAN_SLAB_ELEMENTS", slab)
    _eq(pm.masked_median_filter_1d(x, nv, 3), ref)


@pytest.mark.parametrize("half", [1, 2, 8])
@pytest.mark.parametrize("ties", [False, True])
def test_median_filter_select_nth_exact(half, ties):
    """No even-count averaging: the element at count // 2."""
    x = _rows(4, (2, 5, 33), ties)
    _eq(pm.median_filter_1d_select_nth(torch.as_tensor(x), half),
        jm.median_filter_1d_select_nth(jnp.asarray(x), half))


@pytest.mark.parametrize("half", [2, 8])
def test_masked_select_nth_filter_exact(half):
    x = _rows(5, (4, 12, 40), True)
    nv = np.asarray([40, 13, 0, 5])[:, None]
    _eq(pm.masked_select_nth_filter_1d(torch.as_tensor(x), torch.as_tensor(nv), half),
        jpost._median_select_nth_masked(jnp.asarray(x), jnp.asarray(nv), half))


def test_the_three_medians_differ_where_they_should():
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0]])
    assert pm.median_filter_1d(x, 1)[0, 0] == 2.5  # window (4, 1): the mean
    assert pm.median_filter_1d_select_nth(x, 1)[0, 0] == 4.0  # element 2 // 2 of (1, 4)
    out = pm.masked_median_filter_1d(x, torch.tensor([2]), 1)
    assert out[0].tolist() == [2.5, 2.5, 3.0, 2.0]  # clipped to two entries, the rest kept


def test_sums_means_windows_distances_topk():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 50)).astype(np.float32)
    mask = rng.random((3, 50)) < 0.4
    mask[2] = False
    tx, tm = torch.as_tensor(x), torch.as_tensor(mask)
    np.testing.assert_allclose(pm.masked_sum(tx, tm).numpy(),
                               np.asarray(jm.masked_sum(jnp.asarray(x), jnp.asarray(mask))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pm.masked_mean(tx, tm).numpy(),
                               np.asarray(jm.masked_mean(jnp.asarray(x), jnp.asarray(mask))),
                               rtol=1e-6, atol=1e-6)
    for left, right in ((0, 0), (2, 0), (1, 3)):
        _eq(pm.windowed_any(tm, left, right), jm.windowed_any(jnp.asarray(mask), left, right))
    _eq(pm.distance_to_nearest_true(tm), jm.distance_to_nearest_true(jnp.asarray(mask)))
    xt = np.round(x * 2) / 2  # ties: the lowest index first
    vals, idx = pm.top_k_masked(torch.as_tensor(xt), tm, 7)
    rv, ri = jm.top_k_masked(jnp.asarray(xt), jnp.asarray(mask), 7)
    _eq(vals, rv)
    np.testing.assert_array_equal(idx.numpy()[:2], np.asarray(ri)[:2])
    assert np.isneginf(vals.numpy()[2]).all()
