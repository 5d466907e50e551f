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


@pytest.mark.parametrize("half", [1, 2, 5, 0, 10, 40])
@pytest.mark.parametrize("ties", [False, True])
def test_median_filter_1d_exact(half, ties):
    x = _rows(1, (3, 4, 37), ties)
    _eq(pm.median_filter_1d(torch.as_tensor(x), half), jm.median_filter_1d(jnp.asarray(x), half))


@pytest.mark.parametrize("half", [1, 3, 10, 0, 2, 8, 40])
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


@pytest.mark.parametrize("half", [1, 2, 8, 0, 10, 40])
@pytest.mark.parametrize("ties", [False, True])
def test_median_filter_select_nth_exact(half, ties):
    """No even-count averaging: the element at count // 2."""
    x = _rows(4, (2, 5, 33), ties)
    _eq(pm.median_filter_1d_select_nth(torch.as_tensor(x), half),
        jm.median_filter_1d_select_nth(jnp.asarray(x), half))


@pytest.mark.parametrize("half", [2, 8, 0, 1, 10, 40])
def test_masked_select_nth_filter_exact(half):
    x = _rows(5, (4, 12, 40), True)
    nv = np.asarray([40, 13, 0, 5])[:, None]
    _eq(pm.masked_select_nth_filter_1d(torch.as_tensor(x), torch.as_tensor(nv), half),
        jpost._median_select_nth_masked(jnp.asarray(x), jnp.asarray(nv), half))


@pytest.mark.parametrize("half", [0, 1, 2, 8, 10, 40])
@pytest.mark.parametrize("average_even", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_median_along_a_middle_axis_is_the_last_axis_form(half, average_even, ties):
    """``[outer, n, inner]`` with the filtered axis in the middle, as the
    kernel takes it: equal to the transposed last-axis form and to the JAX
    package, on ragged rows (0, 1, 2, even, odd and whole valid lengths),
    ties and zeros."""
    x = _rows(7, (6, 29, 5), ties)
    x[:, ::4, 1] = 0.0
    nv = np.asarray([0, 1, 2, 14, 17, 29])
    got = pm.window_median(torch.as_tensor(x), torch.as_tensor(nv), half, average_even, dim=1)
    xt = torch.as_tensor(x).transpose(1, 2)
    last = pm.window_median(xt, torch.as_tensor(nv)[:, None], half, average_even).transpose(1, 2)
    _eq(got, last.numpy())
    ref = jm.masked_median_filter_1d if average_even else jpost._median_select_nth_masked
    want = ref(jnp.asarray(xt.numpy()), jnp.asarray(nv)[:, None], half)
    _eq(got, np.asarray(want).transpose(0, 2, 1))
    np.testing.assert_array_equal(got.numpy()[0], x[0])  # nothing valid: unchanged


def test_the_kernel_refuses_what_it_does_not_take():
    """The kernel's view of a tensor (``window_median_shape``) takes f32
    contiguous tensors and a half-width of 0 or more; a device that is
    neither the CPU nor a CUDA card is refused before any view."""
    x = torch.zeros((2, 50, 40))
    assert pm.window_median_shape(x, 1, 3) == (2, 50, 40)
    assert pm.window_median_shape(x, -1, 3) == (100, 40, 1)
    assert pm.window_median_shape(x, 0, 0) == (1, 2, 2000)
    with pytest.raises(ValueError, match="f32"):
        pm.window_median_shape(x.double(), 1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        pm.window_median_shape(x.transpose(1, 2), 1, 3)
    with pytest.raises(ValueError, match="half-width"):
        pm.window_median_shape(x, 1, -1)
    with pytest.raises(ValueError, match="unsupported device"):
        pm.window_median(x.to("meta"), None, 3, True, 1)


def test_window_median_bound_counts_eight_bytes_a_cell():
    """``window_median_bound_ms``: each f32 cell read once and written once;
    two binary searches a cell as the least operations, far below the
    bytes' time at the HPSS cell's shape."""
    cells = 16 * 15500 * 1025
    b = pm.window_median_bound_ms(16, 15500, 1025, 10)
    assert b["bytes"] == 8 * cells
    assert b["operations"] == cells * 2 * 5  # ceil(log2(21)) = 5
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(8 * cells / 3.35e12 * 1e3)
    assert pm.window_median_bound_ms(2, 3, 4, 0)["operations"] == 0  # a window of one


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


@pytest.mark.parametrize("shape, dim", [((3, 7), -1), ((2, 16), -1), ((2, 17), -1),
                                        ((4, 100), -1), ((16, 3101), -1), ((2, 1000, 24), -2),
                                        ((40, 3104), -1)])
def test_scan_sum_adds_in_the_reference_order(shape, dim):
    """``scan_sum`` is bit-equal to the reference's compiled ``jnp.cumsum``
    (a scan of 16-wide blocks over a recursive scan of their totals), where
    ``torch.cumsum`` is not."""
    import jax

    x = (np.random.default_rng(5).random(shape) ** 3 * 40).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=dim))(x))
    np.testing.assert_array_equal(pm.scan_sum(torch.as_tensor(x), dim).numpy(), want)


@pytest.mark.parametrize("shape", [(3, 31), (3, 32), (2, 63), (16, 255), (16, 1023), (7, 2047),
                                   (5, 512), (4, 97, 512)])
def test_tree_sum_adds_in_the_reference_order(shape):
    """``tree_sum`` is bit-equal to the reference's compiled ``jnp.sum`` over
    the widths the pipeline sums over (beat slots of 2^k - 1, 512-sample
    blocks): left-to-right sums of 32-wide blocks, summed the same way."""
    import jax

    x = np.random.default_rng(6).uniform(0.5, 1.0, shape).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=-1))(x))
    np.testing.assert_array_equal(pm.tree_sum(torch.as_tensor(x)).numpy(), want)
