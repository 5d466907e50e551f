"""The port's Viterbi decode (``stratum_dsp_tpu_torch/ops/viterbi.py``) and
``features/beat/hmm.py:track_beats`` against the JAX package.

On the CPU the wrapper runs its plain PyTorch version. It must equal the
Pallas kernel (interpret mode) state for state, also where the path
probabilities underflow through f32 denormals to 0, and ``track_beats``
must equal the JAX function's beat times, beat mask and states exactly (its
beat confidences to two f32 ulps: the two libraries' ``exp`` differ there). The CUDA kernel is
compared with the plain version on the card (``cuda`` marker).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stratum_dsp_tpu.features.beat import hmm as jhmm
from stratum_dsp_tpu.ops.viterbi_pallas import _transition_matrix
from stratum_dsp_tpu.ops.viterbi_pallas import viterbi_decode as jax_viterbi
from stratum_dsp_tpu_torch.features.beat import hmm as phmm
from stratum_dsp_tpu_torch.ops import viterbi

torch.set_num_threads(2)


def _underflow_batch(rng):
    """300 frames of emissions near 1e-3 (the path probabilities pass
    through f32 denormals to 0 within ~15 frames), then a tail of 0; one row
    of exactly 1e-3, one jittered, one with the zero tail from frame 150."""
    em = np.zeros((3, 400), np.float32)
    em[:, :300] = 1e-3
    em[1, :300] = rng.uniform(5e-4, 2e-3, 300).astype(np.float32)
    em[2, 150:] = 0.0
    return em


def _steady_batch(rng, t):
    """Emissions near 0.85 / 0.7, the inverse of the edge states' normalized
    self-transition: the path probabilities neither underflow nor overflow,
    so every frame is decoded from live values."""
    em = np.full((3, t), 1.21, np.float32)
    em[1:] *= rng.uniform(0.97, 1.03, (2, t)).astype(np.float32)
    return em


@pytest.mark.parametrize("case", ["uniform", "underflow", "steady", "two-frames", "one-frame"])
def test_plain_matches_pallas_interpret(rng, case):
    if case == "uniform":
        em = rng.uniform(0.01, 1.0, (3, 128)).astype(np.float32)
    elif case == "underflow":
        em = _underflow_batch(rng)
    else:
        em = _steady_batch(rng, {"steady": 161, "two-frames": 2, "one-frame": 1}[case])
    ref = np.asarray(jax_viterbi(jnp.asarray(em), True))
    got = viterbi.viterbi_decode(torch.as_tensor(em))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_backtrack_plain_follows_the_maps(rng):
    """``backtrack_plain`` on backpointer maps that are not the identity
    (real emissions only produce state 0), against a loop written out."""
    b, t = 4, 37
    bp = rng.integers(0, 5, (b, t, 5))
    last = rng.integers(0, 5, b)
    want = np.zeros((b, t), np.int64)
    for r in range(b):
        s = want[r, t - 1] = last[r]
        for i in range(t - 1, 0, -1):
            s = want[r, i - 1] = bp[r, i, s]
    got = viterbi.backtrack_plain(torch.as_tensor(bp), torch.as_tensor(last))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) == 5


def test_live_frames_and_bound(rng):
    """``live_frames``: the frames up to the one at which all probabilities
    are 0; from the frame before on the decoded states are 0. ``bound_ms``
    counts those frames' emissions only."""
    t = 96
    em = rng.uniform(0.01, 1.0, (5, t)).astype(np.float32)
    em[0] = 1e-3            # underflows through denormals
    em[1, 50:] = 0.0        # a zero tail: dead at frame 50
    em[2] = 1.0             # sinks to the smallest denormal and stays there
    em[3] = 1.21            # steady
    em[4, 0] = 0.0          # dead from the first frame
    frames = viterbi.live_frames(torch.as_tensor(em)).tolist()
    assert frames[1] == 51 and frames[2] == frames[3] == t and frames[4] == 1
    assert 12 <= frames[0] <= 16
    states = viterbi.viterbi_decode_plain(torch.as_tensor(em)).numpy()
    for row, k in enumerate(frames):
        assert not states[row, k - 1:].any(), row
    whole = viterbi.bound_ms(5, t)
    assert whole["bytes"] == 5 * t * 4 + 100 + 5 * t * 4 and whole["bound_by"] == "bytes"
    counted = viterbi.bound_ms(5, t, frames)
    assert counted["bytes"] == sum(frames) * 4 + 100 + 5 * t * 4
    assert counted["operations"] == sum(frames) * 30
    assert counted["bound_ms"] == pytest.approx(counted["bytes"] / 3.35e12 * 1e3)


def test_transition_table_bit_equal():
    assert viterbi.transition_matrix().dtype == np.float32
    assert viterbi.transition_matrix().tobytes() == _transition_matrix().tobytes()
    assert viterbi.transition_matrix().tobytes() == np.asarray(jhmm.transition_matrix()).tobytes()


@pytest.mark.parametrize("fill", [False, True])
def test_track_beats_matches_jax(fill):
    """Beats and states of track_beats, with rows without onsets, an invalid
    BPM and a phase anchor, against the JAX function."""
    rng = np.random.default_rng(5)
    b, k, mb = 5, 48, 128
    bpm = np.asarray([120.0, 97.3, 174.0, 0.0, 88.0], np.float32)
    onsets = np.sort(rng.uniform(0.0, 30.0, (b, k)).astype(np.float32), axis=-1)
    onsets[0] = np.arange(k, dtype=np.float32) * np.float32(0.5) + np.float32(0.013)
    valid = np.ones((b, k), bool)
    valid[1, 30:] = False
    valid[4] = False
    anchor = (onsets[:, 0] + np.float32(0.004)).astype(np.float32)
    for anc in (None, anchor):
        ref_beats, ref_states = jhmm.track_beats(
            jnp.asarray(bpm), jnp.asarray(onsets), jnp.asarray(valid), mb,
            None if anc is None else jnp.asarray(anc), None, fill)
        got_beats, got_states = phmm.track_beats(
            torch.as_tensor(bpm), torch.as_tensor(onsets), torch.as_tensor(valid), mb,
            None if anc is None else torch.as_tensor(anc), None, fill)
        for name in ("times", "valid"):
            np.testing.assert_array_equal(getattr(got_beats, name).numpy(),
                                          np.asarray(getattr(ref_beats, name)), err_msg=name)
        # XLA's f32 exp and PyTorch's differ by one ulp for ~9% of arguments;
        # the confidence 0.7 * emission + 0.3 * align can sit in the binade
        # below the emission, where that ulp is up to 1.4 of its own, so two
        # ulps; XLA:CPU also flushes denormal results to 0 (ROADMAP.md Queue 3)
        conf = got_beats.confidence.numpy()
        conf = np.where(np.abs(conf) < np.finfo(np.float32).tiny, np.float32(0.0), conf)
        np.testing.assert_array_max_ulp(conf, np.asarray(ref_beats.confidence), maxulp=2)
        np.testing.assert_array_equal(got_states.numpy(), np.asarray(ref_states))
        assert got_beats.valid[0].any()


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda:0")
    batches = [np.concatenate([rng.uniform(0.01, 1.0, (3, 400)).astype(np.float32),
                               _underflow_batch(rng)])]
    # frame counts around a warp's 32 lanes, and one past 48 KB of shared memory
    batches += [_steady_batch(rng, t) for t in (1, 2, 31, 33, 400, 1024, 2000)]
    for em in batches:
        em = torch.as_tensor(em, device=dev)
        before = viterbi.viterbi_decode.launches
        got = viterbi.viterbi_decode(em)
        assert viterbi.viterbi_decode.launches == before + 1
        assert torch.equal(got, viterbi.viterbi_decode_plain(em)), em.shape


@pytest.mark.cuda
def test_backtrack_scan_matches_plain_on_card(rng):
    """The kernel's backtrack (maps composed by a warp scan) on random
    backpointers, which no emissions produce, against the plain backtrack."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda:0")
    before = viterbi.viterbi_decode.launches
    for t in (1, 2, 5, 32, 33, 64, 1023, 1024, 3000):
        bp = torch.as_tensor(rng.integers(0, 5, (7, t, 5)), device=dev)
        last = torch.as_tensor(rng.integers(0, 5, 7), device=dev)
        got = viterbi.backtrack_on_card(bp, last)
        torch.cuda.synchronize()
        assert torch.equal(got.long(), viterbi.backtrack_plain(bp, last)), t
    assert viterbi.viterbi_decode.launches == before
