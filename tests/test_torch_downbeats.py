"""The port's greedy downbeat walk (``stratum_dsp_tpu_torch/ops/downbeats.py``
and ``features/beat/grid.py:detect_downbeats``) against the JAX package.

On the CPU the wrapper runs its plain PyTorch version; it must equal the
Pallas kernel (interpret mode) and the JAX scan bit for bit, including rows
with no beats, full rows, and beats exactly on the +-10% bar edge. The CUDA
kernel is compared with the plain version on the card (``cuda`` marker).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stratum_dsp_tpu.features.beat import grid as jgrid
from stratum_dsp_tpu.ops.downbeats_pallas import downbeat_mask as jax_downbeat_mask
from stratum_dsp_tpu_torch.features.beat import grid as pgrid
from stratum_dsp_tpu_torch.ops import downbeats

torch.set_num_threads(2)


def _edge_case_batch(rng, n=96, b=8):
    """Sorted beat times with n_beats = 0, = N and partial rows, and rows
    whose beats fall exactly on the +-10% edges of one bar."""
    bar = rng.uniform(1.2, 3.0, b).astype(np.float32)
    steps = (bar[:, None] / 4.0) * rng.uniform(0.9, 1.1, (b, n)).astype(np.float32)
    times = np.cumsum(steps, axis=1).astype(np.float32)
    k = np.arange(n, dtype=np.float32)
    times[0] = k * (bar[0] * np.float32(1.1) / np.float32(4.0))
    times[1] = k * (bar[1] * np.float32(0.9) / np.float32(4.0))
    times[2] = k * (bar[2] / np.float32(4.0))
    n_beats = rng.integers(1, n, b).astype(np.int32)
    n_beats[[0, 1, 3]] = n
    n_beats[4] = 0
    n_beats[5] = 1
    return times, n_beats, bar


def _parallel_form_batch(rng, n=96):
    """Inputs that a walk evaluated 32 slots at a time could get wrong and
    the slot-by-slot walk defines: counts of 0, 1, 32, 33 and N; beats so
    dense that several slots of one window pass the test (the first must
    win); beats exactly on both edges of the tolerance; times that are not
    sorted; and equal times."""
    b = 10
    bar = rng.uniform(1.2, 3.0, b).astype(np.float32)
    steps = (bar[:, None] / 4.0) * rng.uniform(0.9, 1.1, (b, n)).astype(np.float32)
    times = np.cumsum(steps, axis=1).astype(np.float32)
    k = np.arange(n, dtype=np.float32)
    times[5] = k * (bar[5] / np.float32(16.0))
    times[6] = k * (bar[6] * np.float32(1.1) / np.float32(4.0))
    times[7] = k * (bar[7] * np.float32(0.9) / np.float32(4.0))
    times[8] = rng.permutation(times[8])
    times[9] = times[9, 3]
    n_beats = np.asarray([0, 1, 32, 33, n, n, n, n, n, n], np.int32)
    return times, n_beats, bar


@pytest.mark.parametrize("batch", [_edge_case_batch, _parallel_form_batch])
def test_plain_matches_pallas_interpret(rng, batch):
    times, n_beats, bar = batch(rng)
    ref = np.asarray(jax_downbeat_mask(jnp.asarray(times), jnp.asarray(n_beats),
                                       jnp.asarray(bar), True))
    got = downbeats.downbeat_mask(torch.as_tensor(times), torch.as_tensor(n_beats),
                                  torch.as_tensor(bar))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    if batch is _edge_case_batch:
        assert not ref[4].any() and ref[5, 0] and ref[5, 1:].sum() == 0
    else:
        assert not ref[0].any() and ref[1].sum() == 1 and ref[2, 32:].sum() == 0
        assert ref[5].sum() > 4 and ref[8].sum() >= 1 and ref[9].sum() == 1
        # dense beats: between two downbeats lie slots that also pass the test
        # against the earlier one, so taking any but the first would differ
        first, second = np.nonzero(ref[5])[0][:2]
        near = np.abs(times[5] - (times[5, first] + bar[5])) <= bar[5] * np.float32(0.1)
        assert near[second] and near.sum() >= 2 and not near[:second].any()


@pytest.mark.parametrize("sig", [0, 1, 2])
def test_detect_downbeats_matches_jax_scan(rng, sig):
    """grid.detect_downbeats (bar from BPM and time signature) vs the JAX
    scan, the form the reference runs off the TPU."""
    b, n = 6, 128
    bpm = rng.uniform(70, 180, b).astype(np.float32)
    beat = np.float32(60.0) / bpm
    times = np.cumsum(beat[:, None] * rng.uniform(0.95, 1.05, (b, n)).astype(np.float32), axis=1)
    times = times.astype(np.float32)
    n_beats = np.asarray([n, 0, 1, 50, n - 1, 7], np.int32)
    sig_idx = np.full(b, sig, np.int32)
    ref = np.asarray(jgrid.detect_downbeats(jnp.asarray(times), jnp.asarray(n_beats),
                                            jnp.asarray(bpm), jnp.asarray(sig_idx)))
    got = pgrid.detect_downbeats(torch.as_tensor(times), torch.as_tensor(n_beats),
                                 torch.as_tensor(bpm), torch.as_tensor(sig_idx))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_bound_counts_what_the_data_needs():
    """``bound_ms``: every slot's time read and its mask byte written from the
    shapes alone; with the batch's beat counts only the slots below each."""
    whole = downbeats.bound_ms(40, 3072)
    assert whole["bytes"] == 40 * 3072 * 4 + 40 * 8 + 40 * 3072
    assert whole["bound_by"] == "bytes"
    assert whole["bound_ms"] == pytest.approx(whole["bytes"] / 3.35e12 * 1e3)
    counted = downbeats.bound_ms(40, 3072, [0, 1, 3072, 5000, -3] + [400] * 35)
    assert counted["bytes"] == (1 + 3072 + 3072 + 35 * 400) * 4 + 40 * 8 + 40 * 3072
    assert counted["operations"] == 6 * (1 + 3072 + 3072 + 35 * 400)
    assert counted["bound_ms"] < whole["bound_ms"]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda:0")
    # 3072 is the main path's width; 5000 slots need more than 48 KB of shared memory
    for batch, n in ((_edge_case_batch, 3072), (_parallel_form_batch, 3072),
                     (_parallel_form_batch, 100), (_parallel_form_batch, 33),
                     (_edge_case_batch, 5000)):
        times, n_beats, bar = batch(rng, n=n)
        args = [torch.as_tensor(x, device=dev) for x in (times, n_beats, bar)]
        before = downbeats.downbeat_mask.launches
        got = downbeats.downbeat_mask(*args)
        assert downbeats.downbeat_mask.launches == before + 1
        assert torch.equal(got, downbeats.downbeat_mask_plain(*args)), (batch.__name__, n)
